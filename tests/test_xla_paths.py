"""CPU tests of the single XLA path every platform runs: stage dispatch,
the LCP candidate stage and the greedy cover against independent numpy
references, the integer remainder of the indexed decoders, the compile
cache placement, and chip_smoke.py's refusal to run without a GPU."""

import functools
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from compu_tpu.kernels import deflate_jax_v2 as v2  # noqa: E402
from compu_tpu.kernels import deflate_jax_v3 as v3  # noqa: E402
from compu_tpu.kernels.lcp_match import (  # noqa: E402
    lcp_candidates_xla,
    sort_stage_lex,
)

ALICE = (REPO / "tests" / "data" / "alice29.txt").read_bytes()


# ---------------------------------------------------------------------------
# (a) stage dispatch: one XLA form per stage, on every backend
# ---------------------------------------------------------------------------

def _primitives(jaxpr) -> set:
    names = set()
    for eqn in jaxpr.eqns:
        names.add(eqn.primitive.name)
        for param in eqn.params.values():
            subs = param if isinstance(param, (list, tuple)) else [param]
            for sub in subs:
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    names |= _primitives(getattr(inner, "jaxpr", inner))
    return names


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_stages_pick_xla_forms(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    calls = {"lcp": 0, "cover": 0, "emit": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(v2, "lcp_candidates_xla",
                        counted("lcp", v2.lcp_candidates_xla))
    monkeypatch.setattr(v2, "parse_cover_mxu",
                        counted("cover", v2.parse_cover_mxu))
    monkeypatch.setattr(v3, "emit_pack_xla", counted("emit", v3.emit_pack_xla))
    N = 1024
    blocks = jnp.zeros((2, N), jnp.uint8)
    lens = jnp.full(2, N, jnp.int32)
    fn = functools.partial(v3.encode_blocks_dyn.__wrapped__, depth=4,
                           with_index=True, check="crc", wcap=8, lex_keys=2)
    closed = jax.make_jaxpr(fn)(blocks, lens)
    assert calls["lcp"] >= 1 and calls["cover"] >= 1 and calls["emit"] >= 1
    assert "pallas_call" not in _primitives(closed.jaxpr)


def test_no_module_imports_mosaic_pallas():
    # the Mosaic Pallas backends (jax.experimental.pallas.t[p]u and
    # mosaic_gpu) and interpret-mode kernels have no place in the package
    pattern = re.compile(r"pallas[. ]+import\s+t[p]u|pallas\.t[p]u|plt[p]u|"
                         r"mosaic_gpu|interpret=")
    hits = [str(p.relative_to(REPO))
            for p in (REPO / "compu_tpu").rglob("*.py")
            if pattern.search(p.read_text())]
    assert hits == []


# ---------------------------------------------------------------------------
# (b) LCP candidates against a brute-force window compare
# ---------------------------------------------------------------------------

def _lcp_reference(blocks: np.ndarray, ps: np.ndarray, *, wcap: int,
                   depth: int, max_dist: int, block_elems: int):
    """Best (len, dist) per sorted lane by direct byte comparison of the
    wcap-byte windows (rolled within the block, as the sort stage reads
    them) of every neighbour up to ``depth`` away, in both directions,
    inside the same block; ties prefer the nearer source."""
    B, N = blocks.shape
    total = ps.shape[0]
    win = np.stack([np.roll(blocks, -k, axis=1) for k in range(wcap)], -1)
    best_len = np.zeros(total, np.int64)
    best_dist = np.zeros(total, np.int64)
    for i in range(total):
        b = i // block_elems
        lo, hi = b * block_elems, (b + 1) * block_elems
        wi = win[b, ps[i]]
        for j in range(max(lo, i - depth), min(hi, i + depth + 1)):
            if j == i:
                continue
            dist = int(ps[i]) - int(ps[j])
            if not 0 < dist <= max_dist:
                continue
            diff = np.nonzero(wi != win[b, ps[j]])[0]
            length = int(diff[0]) if diff.size else wcap
            if length == 0:
                continue
            if length > best_len[i] or (length == best_len[i]
                                        and dist < best_dist[i]):
                best_len[i], best_dist[i] = length, dist
    return best_len, best_dist


def _lcp_blocks(case: str, N: int) -> np.ndarray:
    rng = np.random.default_rng(5)
    text = np.frombuffer(ALICE[: 2 * N], np.uint8)
    if case == "text":
        return np.stack([text[:N], text[N: 2 * N]])
    if case == "cross_block_repeat":
        # block 1 repeats block 0: any candidate crossing the block
        # boundary would be a long false match
        return np.stack([text[:N], text[:N]])
    if case == "boundary_chain":
        # block 0's largest window ("m" * 8 at position 0) equals block 1's
        # smallest (at position 100): adjacent across the boundary in
        # sorted order, at a valid positive distance
        b0 = np.full(N, ord("a"), np.uint8)
        b0[:8] = ord("m")
        b1 = np.full(N, ord("z"), np.uint8)
        b1[100:108] = ord("m")
        return np.stack([b0, b1])
    # low-entropy bytes: dense ties between equal windows
    return rng.integers(0, 4, (2, N), dtype=np.uint8)


@pytest.mark.parametrize("case", ["text", "cross_block_repeat",
                                  "boundary_chain", "dense"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("depth", [1, 8, 16])
def test_lcp_candidates_match_bruteforce(depth, stride, case):
    N, wcap, max_dist = 256, 8, 200
    blocks = _lcp_blocks(case, N)
    sort_fn = functools.partial(sort_stage_lex, wcap=wcap, stride=stride,
                                keys=wcap // 4)  # full lexicographic order
    ops = jax.vmap(sort_fn)(jnp.asarray(blocks), jnp.full(2, N, jnp.int32))
    flat = tuple(w.reshape(-1) for w in ops)
    block_elems = N // stride
    got_len, got_dist = lcp_candidates_xla(flat, depth=depth,
                                           max_dist=max_dist,
                                           block_elems=block_elems)
    ref_len, ref_dist = _lcp_reference(
        blocks, np.asarray(flat[-1]), wcap=wcap, depth=depth,
        max_dist=max_dist, block_elems=block_elems)
    np.testing.assert_array_equal(np.asarray(got_len), ref_len)
    np.testing.assert_array_equal(np.asarray(got_dist), ref_dist)


# ---------------------------------------------------------------------------
# (c) greedy cover against a sequential walk
# ---------------------------------------------------------------------------

def _cover_reference(step: np.ndarray, seg: int) -> np.ndarray:
    out = np.zeros(step.shape[0], bool)
    for base in range(0, step.shape[0], seg):
        pos = 0
        while pos < seg:
            out[base + pos] = True
            pos = min(pos + max(int(step[base + pos]), 1), seg)
    return out


def _steps(pattern: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(3)
    if pattern == "literals":
        return np.ones(n, np.int32)
    if pattern == "long_matches":
        return np.full(n, 258, np.int32)
    return np.where(rng.random(n) < 0.4, rng.integers(3, 40, n), 1).astype(
        np.int32)


@pytest.mark.parametrize("pattern", ["literals", "long_matches", "random"])
@pytest.mark.parametrize("seg", [64, 128])
def test_parse_cover_matches_sequential_greedy(seg, pattern):
    step = _steps(pattern, 8 * seg)
    got = np.asarray(v2.parse_cover_mxu(jnp.asarray(step), seg))
    np.testing.assert_array_equal(got, _cover_reference(step, seg))


# ---------------------------------------------------------------------------
# (d) integer remainder == the f32 floor-division form it replaced
# ---------------------------------------------------------------------------

def test_rel_mod_matches_f32_floor_form():
    from compu_tpu.kernels.inflate_jax import rel_mod

    rel, dist = np.meshgrid(np.arange(258, dtype=np.int32),
                            np.arange(1, 32769, dtype=np.int32))
    rel = jnp.asarray(rel.reshape(-1))
    dist = jnp.asarray(dist.reshape(-1))

    @jax.jit
    def old(rel, dist):
        q = jnp.floor(rel.astype(jnp.float32) / dist.astype(jnp.float32))
        return rel - q.astype(jnp.int32) * dist

    new = np.asarray(jax.jit(rel_mod)(rel, dist))
    np.testing.assert_array_equal(new, np.asarray(old(rel, dist)))
    np.testing.assert_array_equal(new, np.asarray(rel) % np.asarray(dist))


# ---------------------------------------------------------------------------
# (e) compile cache placement
# ---------------------------------------------------------------------------

def test_compile_cache_uses_environment(monkeypatch, tmp_path):
    from compu_tpu.utils import compile_cache

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == (str(tmp_path), True)
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert updates == []  # JAX reads the variable itself


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    from compu_tpu.utils import compile_cache

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.setup_compile_cache()
    assert pathlib.Path(path) == REPO / ".jax_cache"
    assert updates == [("jax_compilation_cache_dir", path)]
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


# ---------------------------------------------------------------------------
# (f) chip_smoke.py refuses to run without a GPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
