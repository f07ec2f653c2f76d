"""Port streamed all-gather GEMM against the JAX package on the CPU: the
port's ``streamed_gemm`` (on CPU tensors, its plain version after the
kernel's checks) against the Pallas kernel in interpret mode, the refusals,
the bars, the bench record, and ``allgather_gemm`` over four gloo ranks.

Inputs are made with numpy from a seed and handed to both packages with the
same bits.  Tolerances, each with its reason:
- f32: atol 2e-4, rtol 2e-5, the bar of tests/test_kernels.py's
  streamed-GEMM test (w scaled 0.2 as there): the same f32 products,
  summed in another order;
- bf16: 1e-2 of the output's largest magnitude (``allgather_gemm.tolerance``):
  both sides round an f32 sum to bf16, one step of which is up to 2^-7 of
  the largest |y|;
- ``allgather_gemm`` against its oracle and against the JAX kernel on the
  gathered x: 1e-3, the bar of the JAX mesh test (tests/test_kernels.py:203).

The four ranks run in a subprocess that starts them with ``spawn`` and
meets through a ``FileStore`` under ``tmp_path``: nothing here forks or
starts a pool.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import streamed_gemm as jax_streamed_gemm
from repro.kernels.allgather_gemm import BUDGET_SHAPES as JAX_BUDGET_SHAPES
from repro_torch.kernels.allgather_gemm import (BUDGET_SHAPES, CLUSTER,
                                                TILES, boundary_shapes, check,
                                                streamed_gemm, tolerance)
from repro_torch.kernels.ref import streamed_gemm_ref
from repro_torch.launch import kernel_bench as kb

ROOT = Path(__file__).resolve().parents[1]
F32_ATOL, F32_RTOL = 2e-4, 2e-5
MESH_TOL = 1e-3
# tests/test_kernels.py's streamed-GEMM shapes (M, K, N, chunks)
JAX_SHAPES = [(64, 256, 128, 8), (128, 512, 256, 4), (8, 128, 128, 2)]


def _inputs(seed, M, K, N, dtype="float32"):
    """x (M, K) and w (K, N) (scaled 0.2, as the JAX test) with the same
    bits in both packages."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.2).astype(np.float32)
    jx, jw = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w))
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (jx, jw))
    return (jx, jw), (tx, tw)


@pytest.mark.parametrize("M,K,N,chunks", JAX_SHAPES)
@pytest.mark.parametrize("buffers", [1, 2])
def test_streamed_gemm_matches_jax(M, K, N, chunks, buffers):
    (jx, jw), (tx, tw) = _inputs(0, M, K, N)
    want = jax_streamed_gemm(jx, jw, chunks=chunks, buffers=buffers,
                             interpret=True)
    got = streamed_gemm(tx, tw, chunks=chunks, buffers=buffers)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL,
                               rtol=F32_RTOL)


@pytest.mark.parametrize("M,K,N,chunks", JAX_SHAPES)
def test_streamed_gemm_matches_jax_in_bf16(M, K, N, chunks):
    """bf16 operands, f32 accumulation, a bf16 output on both sides."""
    (jx, jw), (tx, tw) = _inputs(1, M, K, N, "bfloat16")
    want = np.asarray(jax_streamed_gemm(jx, jw, chunks=chunks,
                                        interpret=True).astype(jnp.float32))
    got = streamed_gemm(tx, tw, chunks=chunks)
    assert got.dtype == torch.bfloat16
    atol, rtol = tolerance(torch.bfloat16, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_sums_chunks_in_f32(dtype):
    """The plain version is the f32 sum of the chunk products, rounded once
    to the output's dtype, whatever the chunk count."""
    (_, _), (x, w) = _inputs(2, 24, 96, 40, str(dtype)[6:])
    one = streamed_gemm_ref(x, w, chunks=1)
    assert one.dtype == dtype
    torch.testing.assert_close(one, (x.float() @ w.float()).to(dtype))
    for chunks in (2, 3, 12):
        got = streamed_gemm_ref(x, w, chunks=chunks)
        torch.testing.assert_close(got.float(), one.float(),
                                   atol=1e-5 if dtype == torch.float32
                                   else 0.02 * float(one.abs().max()),
                                   rtol=0)


def test_streamed_gemm_validates_chunking():
    """The JAX test's refusals, with its match strings."""
    with pytest.raises(ValueError, match="must divide"):
        streamed_gemm(torch.zeros(16, 100), torch.zeros(100, 128), chunks=3)
    with pytest.raises(ValueError, match="buffers"):
        streamed_gemm(torch.zeros(16, 128), torch.zeros(128, 128), chunks=2,
                      buffers=3)


@pytest.mark.parametrize("x,w,chunks,exc,match", [
    ((16, 128), (120, 128), 2, ValueError, "K=128 columns"),
    ((16, 128), (128, 132), 2, ValueError, "16-byte aligned"),      # bf16 N
    ((16, 128), (128, 128), 32, ValueError, "K/chunks=4"),          # bf16 kc
    ((16, 120), (120, 128), 10, ValueError, "K/chunks=12"),         # bf16 kc
    ((16,), (16, 128), 1, ValueError, "want x"),
])
def test_card_rules_refuse_on_the_cpu_too(x, w, chunks, exc, match):
    """The kernel's own rules (16-byte rows and chunk starts for cp.async)
    are checked on every device, in bf16 here."""
    xs, ws = torch.zeros(*x, dtype=torch.bfloat16), \
        torch.zeros(*w, dtype=torch.bfloat16)
    with pytest.raises(exc, match=match):
        streamed_gemm(xs, ws, chunks=chunks)


def test_dtype_and_layout_refusals():
    with pytest.raises(TypeError, match="share one dtype"):
        check(torch.zeros(8, 16), torch.zeros(16, 8, dtype=torch.bfloat16),
              2, 2)
    with pytest.raises(TypeError, match="share one dtype"):
        check(torch.zeros(8, 16, dtype=torch.float16),
              torch.zeros(16, 8, dtype=torch.float16), 2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        check(torch.zeros(16, 8).t(), torch.zeros(16, 8), 2, 2)


def test_tolerance():
    assert tolerance(torch.float32, 50.0) == (F32_ATOL, F32_RTOL)
    atol, rtol = tolerance(torch.bfloat16, 3.0)
    assert rtol == 0 and atol == pytest.approx(3e-2)
    assert 2 ** -7 * 3.0 < atol     # one bf16 step of the largest output
    with pytest.raises(TypeError):
        tolerance(torch.float16, 1.0)


def test_budget_shapes_and_tiles():
    """The JAX kernel's budget shapes, copied; every one (and the
    full-width shape) meets the card's alignment rule in both dtypes."""
    assert BUDGET_SHAPES == JAX_BUDGET_SHAPES
    for M, K, N, chunks in (*BUDGET_SHAPES, kb.STREAMED_GEMM_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            check(torch.empty(M, K, dtype=dtype, device="meta"),
                  torch.empty(K, N, dtype=dtype, device="meta"), chunks, 2)
    assert set(TILES) == set(CLUSTER) == {torch.float32, torch.bfloat16}


N_EDGES = 15


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(N_EDGES))
def test_boundary_shapes_pass_the_checks_and_the_plain_version(dtype, case):
    """Every edge of the tiling (``boundary_shapes``, which the card's tests
    and chip_smoke run) is a shape the kernel takes, and the plain version
    there is the f32 product rounded once to the dtype."""
    shapes = boundary_shapes(dtype)
    assert len(shapes) == N_EDGES
    M, K, N, chunks = shapes[case]
    (_, _), (x, w) = _inputs(10 + case, M, K, N, str(dtype)[6:])
    check(x, w, chunks, 2)
    got = streamed_gemm(x, w, chunks=chunks)
    want = (x.float() @ w.float())
    assert got.dtype == dtype and got.shape == (M, N)
    atol, rtol = (1e-4, 1e-5) if dtype == torch.float32 else \
        tolerance(dtype, float(want.abs().max()))
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


def test_boundary_shapes_reach_every_edge():
    """What the edges are for: M and N on both sides of a tile, odd counts
    of row tiles (a bf16 cluster's spare tile) and of column tiles, kc from
    below a k-tile to 1024, one chunk, and more bf16 units (clusters' worth
    of tiles) than 66 clusters (132 SMs) run at once."""
    for dtype in (torch.float32, torch.bfloat16):
        bm, bn, bk = TILES[dtype]
        shapes = boundary_shapes(dtype)
        ms = {M for M, _, _, _ in shapes}
        ns = {N for _, _, N, _ in shapes}
        kcs = {K // c for _, K, _, c in shapes}
        assert {1, bm - 1, bm + 1} <= ms and {bn - 8, bn + 8} <= ns
        assert any(-(-M // bm) % 2 == 1 and M > bm for M in ms)
        assert any(-(-N // bn) % 2 == 1 and N > bn for N in ns)
        assert {8, 40, 56, 64, 72, 1024} <= kcs
        assert any(c == 1 for _, _, _, c in shapes)
    assert max(_units(M, N, torch.bfloat16)
               for M, _, N, _ in boundary_shapes(torch.bfloat16)) > 66


def _units(M, N, dtype):
    """Clusters' worth of tiles of a launch.  f32: a tile each.  bf16: two
    tiles each, the column tiles 2p and 2p + 1 of one row tile, then, with
    an odd count of column tiles, the last column's row tiles 2v and
    2v + 1."""
    bm, bn, _ = TILES[dtype]
    tm, tn = -(-M // bm), -(-N // bn)
    if dtype == torch.float32:
        return tm * tn
    return tn // 2 * tm + tn % 2 * -(-tm // 2)


def _l2_bytes_over_the_tiles(M, N, K, dtype):
    """The X and W bytes the CTAs of a launch load, unit by unit.  f32: a
    unit is one tile, which loads its rows of X and columns of W.  bf16: a
    unit is a row pair (one row tile, column tiles 2p and 2p + 1: X's tile
    loaded once for both, each its own W) while two column tiles are left,
    then column pairs of the last column (W's tile once for both, each its
    own X, none for a tile past M).  Rows past M and columns past N load
    nothing."""
    bm, bn, _ = TILES[dtype]
    e = torch.empty((), dtype=dtype).element_size()
    tm, tn = -(-M // bm), -(-N // bn)
    rows = [min(bm, M - m * bm) for m in range(tm)]
    cols = [min(bn, N - n * bn) for n in range(tn)]
    x_bytes = w_bytes = 0
    if dtype == torch.float32:
        for m in range(tm):
            for n in range(tn):
                x_bytes += rows[m] * K * e
                w_bytes += cols[n] * K * e
        return x_bytes, w_bytes
    for n in range(0, tn - 1, 2):           # row pairs
        for m in range(tm):
            x_bytes += rows[m] * K * e
            w_bytes += (cols[n] + cols[n + 1]) * K * e
    if tn % 2:                              # column pairs of the last column
        for m in range(0, tm, 2):
            x_bytes += sum(rows[m:m + 2]) * K * e
            w_bytes += cols[-1] * K * e
    return x_bytes, w_bytes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,K", [(4096, 13696, 4096), (777, 1000, 96)])
def test_streamed_l2_bytes_is_a_count_over_the_tiles(dtype, M, N, K):
    assert kb.streamed_l2_bytes(M, N, K, dtype) == \
        _l2_bytes_over_the_tiles(M, N, K, dtype)


def test_streamed_l2_bytes_at_glm4_shape():
    """The bf16 tiling at glm4-9b's MLP input projection: 16 x 107 tiles in
    16 x 53 row pairs and 8 column pairs, 856 units, 13 rounds of the card's
    66 clusters; X crosses L2 54 times, W's first 13568 columns 16 times
    and its last 128 columns 8 times."""
    M, K, N, _ = kb.STREAMED_GEMM_SHAPE
    x_bytes, w_bytes = kb.streamed_l2_bytes(M, N, K, torch.bfloat16)
    assert x_bytes == 54 * M * K * 2
    assert w_bytes == (16 * 13568 + 8 * 128) * K * 2
    assert _units(M, N, torch.bfloat16) == 16 * 53 + 8 == 856 <= 13 * 66


def test_bench_record_on_the_cpu():
    """bench_streamed_gemm: no time from a CPU run, both modes and the
    plain version agree, and the bound is the operations' at full width."""
    (_, _), (x, w) = _inputs(3, 40, 128, 72)
    rec = kb.bench_streamed_gemm(x, w, chunks=4)
    assert rec["ms"] is None and rec["ms_buffers1"] is None \
        and rec["plain_ms"] is None and rec["library_ms"] is None
    assert rec["device_ms"] is None and rec["library_device_ms"] is None
    assert (rec["l2_bytes_x"], rec["l2_bytes_w"]) == kb.streamed_l2_bytes(
        40, 72, 128, torch.float32)
    assert rec["buffer_agreement_err"] == 0.0 and rec["within_tol"]
    assert rec["shape"] == {"M": 40, "K": 128, "N": 72, "chunks": 4,
                            "dtype": "float32"}
    M, K, N, _ = kb.STREAMED_GEMM_SHAPE
    ms, by = kb.bound(kb.gemm_flops(M, N, K), 2 * (M * K + K * N + M * N),
                      torch.bfloat16)
    assert by == "operations" and abs(ms - 0.4647) < 1e-4


_RANKS = textwrap.dedent('''
    """Four gloo ranks: allgather_gemm against its oracle, and the hidden
    fraction, on the CPU.  Started by spawn; writes rank 0's results."""
    import json
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    WORLD = 4


    def _rank(rank, out_dir):
        from repro_torch.kernels.allgather_gemm import (
            allgather_gemm, allgather_gemm_reference)
        from repro_torch.launch import overlap_bench as ob
        store = dist.FileStore(out_dir + "/store", WORLD)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=WORLD)
        try:
            rng = np.random.default_rng(1)
            X = torch.from_numpy(rng.standard_normal((64, 512)).astype(
                np.float32))
            W = torch.from_numpy(rng.standard_normal((512, 128)).astype(
                np.float32))
            kc = 512 // WORLD
            xs = X[:, rank * kc:(rank + 1) * kc].contiguous()
            ref = allgather_gemm_reference(xs, W)
            outs = {nbuf: allgather_gemm(xs, W, buffers=nbuf)
                    for nbuf in (1, 2)}
            errs = {nbuf: float((o - ref).abs().max())
                    for nbuf, o in outs.items()}
            frac = ob.measure_hidden_fraction(
                None, device=torch.device("cpu"), M=32, K=256, N=64,
                iters=3)
            check = ob.check_allgather_gemm(
                None, device=torch.device("cpu"), M=24, K=100, N=40,
                dtype=torch.bfloat16)
            if rank == 0:
                np.save(out_dir + "/x.npy", X.numpy())
                np.save(out_dir + "/w.npy", W.numpy())
                np.save(out_dir + "/out2.npy", outs[2].numpy())
                np.save(out_dir + "/ref.npy", ref.numpy())
                with open(out_dir + "/result.json", "w") as f:
                    json.dump({"errs": errs, "hidden": frac,
                               "check": check}, f)
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        mp.start_processes(_rank, args=(sys.argv[1],), nprocs=WORLD,
                           start_method="spawn")
''')


def test_allgather_gemm_over_four_gloo_ranks(tmp_path):
    """allgather_gemm (both buffer modes) == allgather_gemm_reference and
    == JAX's streamed_gemm on the gathered x, within 1e-3, over four gloo
    ranks; measure_hidden_fraction's record over those ranks."""
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads((tmp_path / "result.json").read_text())
    assert max(out["errs"].values()) < MESH_TOL, out["errs"]
    x, w = np.load(tmp_path / "x.npy"), np.load(tmp_path / "w.npy")
    want = np.asarray(jax_streamed_gemm(jnp.asarray(x), jnp.asarray(w),
                                        chunks=4, interpret=True))
    got = np.load(tmp_path / "out2.npy")
    assert np.abs(got - want).max() < MESH_TOL
    assert np.abs(np.load(tmp_path / "ref.npy") - want).max() < MESH_TOL
    h = out["hidden"]
    assert h["participants"] == 4 and h["backend"] == "gloo" \
        and h["device"] == "cpu" and not h["degenerate"]
    assert h["shape"] == [32, 256, 64]
    assert all(h[k] > 0 for k in ("t_gather_s", "t_gemm_s",
                                  "t_concurrent_s"))
    assert 0.0 <= h["hidden_fraction"] <= 1.0      # gated nowhere: CPU
    c = out["check"]
    assert c["participants"] == 4 and c["ok"] \
        and c["shape"]["K"] == 128      # 100 rounded up to 4 x 8 x 4
