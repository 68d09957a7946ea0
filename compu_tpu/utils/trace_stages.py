"""Device time per encode stage from a JAX profiler trace.

The batched encode (kernels/deflate_jax_v3.encode_blocks_dyn and the
compaction in kernels/block_codec.py) names its stages with
``jax.named_scope``. XLA keeps those names in each instruction's
``op_name`` metadata; the profiler tags each device kernel with its HLO
instruction (``hlo_op``). Joining the two gives the device time of every
stage. Kernels that XLA runs inside a CUDA graph (``hlo_op`` is
``command_buffer``) are matched by kernel name (fusion ``loop_fusion.3``
launches as ``loop_fusion_3``); library kernels in the same graph launch
(cuBLAS gemms) take the stage of the graph's named kernels.

    python -m compu_tpu.utils.trace_stages TRACE_DIR HLO_TEXT_FILE
"""

from __future__ import annotations

import pathlib
import re
import sys

STAGES = ("sort", "lcp_candidates", "post_match", "cover",
          "tok_hist_checksum", "tree_build", "emit", "compaction")

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s.*?"
                    r"metadata=\{[^}]*?op_name=\"([^\"]*)\"")


def stage_of(op_name: str) -> str | None:
    """First stage scope on an op_name path (its last component is the
    primitive itself, so a bare ``sort`` primitive is not the stage)."""
    for part in op_name.split("/")[:-1]:
        if part in STAGES:
            return part
    return None


def hlo_stages(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> stage, from compiled HLO text."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            stage = stage_of(m.group(2))
            if stage:
                out[m.group(1)] = stage
    return out


def _by_kernel_name(name: str, names: dict[str, str]) -> str | None:
    if name in names:
        return names[name]
    head, _, tail = name.rpartition("_")
    return names.get(f"{head}.{tail}") if tail.isdigit() else None


def stage_times(trace_dir: str, hlo_text: str,
                device: str = "/device:GPU:0") -> dict[str, float]:
    """Milliseconds of device time per stage in the newest trace under
    ``trace_dir`` (plus ``transfer``, ``other``, the busy union and the
    traced window of that device)."""
    from jax.profiler import ProfileData

    path = max(pathlib.Path(trace_dir).rglob("*.xplane.pb"),
               key=lambda p: p.stat().st_mtime)
    names = hlo_stages(hlo_text)
    table = {s: 0.0 for s in (*STAGES, "transfer", "other")}
    spans = []
    for plane in ProfileData.from_file(str(path)).planes:
        if plane.name != device:
            continue
        lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
        for line in lines or list(plane.lines):
            graph: list = []  # consecutive kernels of one CUDA graph launch

            def flush_graph():
                known = [k for _, k in graph if k]
                fill = max(set(known), key=known.count) if known else "other"
                for dur, k in graph:
                    table[k or fill] += dur
                graph.clear()

            for ev in sorted(line.events, key=lambda e: e.start_ns):
                if ev.duration_ns <= 0:
                    continue
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                dur = ev.duration_ns / 1e6
                hlo = str(dict(ev.stats).get("hlo_op", ev.name))
                if hlo == "command_buffer":
                    graph.append((dur, _by_kernel_name(ev.name, names)))
                    continue
                flush_graph()
                if hlo in names:
                    key = names[hlo]
                elif "memcpy" in ev.name.lower() or "memset" in ev.name.lower():
                    key = "transfer"
                else:
                    key = _by_kernel_name(ev.name, names) or "other"
                table[key] += dur
            flush_graph()
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    if spans:
        table["busy_union"] = busy / 1e6
        table["window"] = (max(e for _, e in spans)
                           - min(s for s, _ in spans)) / 1e6
    return table


if __name__ == "__main__":
    for k, v in stage_times(sys.argv[1],
                            pathlib.Path(sys.argv[2]).read_text()).items():
        print(f"{k:<20} {v:10.3f} ms")
