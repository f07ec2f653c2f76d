"""The frozen yardstick (``counts.py``) equals the program's own copies in
``repro_torch.launch.kernel_bench`` today, at the cells' shapes."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import counts  # noqa: E402
from repro_torch.launch import kernel_bench as kb  # noqa: E402

# (B, Hq, Hkv, S, D, window): glm4-9b serving's prefill (16 slots of
# 4096), its training rank (2 x 4096), hymba-1.5b's training (4 x 4096)
ATTENTION = [(16, 32, 2, 4096, 128, None), (2, 32, 2, 4096, 128, None),
             (4, 25, 5, 4096, 64, 1024)]
# (BH, S, P, N): hymba-1.5b's training scan, 4 rows x 50 heads
SSD = [(200, 4096, 64, 16)]


def test_peaks_equal():
    assert counts.PEAK_FLOPS["bfloat16"] == kb.PEAK_FLOPS[torch.bfloat16]
    assert counts.PEAK_FLOPS["float32"] == kb.PEAK_FLOPS[torch.float32]
    assert counts.BYTES_PER_S == kb.BYTES_PER_S


@pytest.mark.parametrize("shape", ATTENTION)
def test_attention_counts_equal(shape):
    B, Hq, Hkv, S, D, w = shape
    assert counts.visible_pairs(S, S, True, w) == \
        kb.visible_pairs(S, S, True, w)
    assert counts.attention_flops(B, Hq, D, S, S, True, w) == \
        kb.attention_flops(B, Hq, D, S, S, True, w)
    q = torch.empty(B, Hq, S, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, Hkv, S, D, dtype=torch.bfloat16, device="meta")
    assert counts.attention_bytes(B, Hq, Hkv, S, S, D) == \
        kb.nbytes(q, k, k) + kb.nbytes(q)


@pytest.mark.parametrize("shape", SSD)
@pytest.mark.parametrize("chunk", counts.SSD_CHUNKS)
def test_ssd_counts_equal(shape, chunk):
    BH, S, P, N = shape
    assert counts.ssd_flops(BH, S, P, N, chunk) == \
        kb.ssd_flops(BH, S, P, N, chunk)


@pytest.mark.parametrize("flops,nbytes", [(1.16e15, 3e9), (7.6e9, 2.14e8)])
def test_bound_equal(flops, nbytes):
    assert counts.bound(flops, nbytes) == \
        kb.bound(flops, nbytes, torch.bfloat16)


def test_served_request_is_a_prefill_and_steps():
    cfg = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
           "d_ff": 128, "vocab_size": 500}
    prefill = counts.forward_flops(cfg, 1, 100, 1)
    assert counts.serve_request_flops(cfg, 100, 0) == prefill
    # one step: each layer's matmuls and 101 keys for each of 4 heads of
    # 16, and the unembed over the padded vocab (512)
    step = 2 * (2 * counts.layer_matmul_params(cfg) + 4 * 4 * 16 * 101) \
        + 2 * 64 * 512
    assert counts.serve_request_flops(cfg, 100, 1) - prefill == step


@pytest.mark.parametrize("window", [None, 1024])
def test_a_launch_over_prompts_counts_their_pairs_alone(window):
    """Rows whose prompts fill the launch count as the launch's shape;
    padding and an empty row add nothing."""
    Hq, Hkv, D, S = 32, 2, 128, 4096
    full = {"B": 2, "Hq": Hq, "Hkv": Hkv, "Sq": S, "Skv": S, "D": D,
            "causal": True, "window": window}
    rows = {"Hq": Hq, "Hkv": Hkv, "D": D, "window": window}
    assert counts.launch_bound_ms("flash_attention_rows",
                                  {**rows, "lengths": [S, S]}) == \
        counts.launch_bound_ms("flash_attention", full)
    flops, nbytes = counts.attention_rows_flops_bytes(
        Hq, Hkv, D, [1500, 0, 3000], window)
    assert flops == 4 * Hq * D * (counts.visible_pairs(1500, 1500, True,
                                                       window)
                                  + counts.visible_pairs(3000, 3000, True,
                                                         window))
    assert nbytes == 2 * D * (2 * Hq + 2 * Hkv) * 4500
