"""The benchmark's frozen yardstick: the card's peaks, the operations and
bytes of each hand-written kernel's launch, and the model FLOPs behind
``mfu``.

The kernel formulas are copies of ``repro_torch.launch.kernel_bench``'s
(``PEAK_FLOPS``, ``BYTES_PER_S``, ``bound``, ``visible_pairs``,
``attention_flops``, ``ssd_flops``), kept here so that a change to the
program cannot change how it is measured; ``tests/test_yardstick.py``
holds the copies equal to the originals at the cells' shapes.  Counts
come from shapes alone: each input byte read once, each output byte
written once, and the work these inputs need.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

# One H100 SXM at its 700 W limit (NVIDIA's data sheet, dense): bf16 on the
# tensor cores; f32 on the CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BYTES_PER_S = 3.35e12                     # HBM3

# the SSD chunks a scan could run at; its least work over them is counted
SSD_CHUNKS = (16, 32, 64, 128, 256)


def bound(flops: float, n_bytes: float, dtype: str = "bfloat16"
          ) -> Tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes"): the larger
    of ``flops`` at the peak rate of ``dtype`` and ``n_bytes`` at the
    memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], n_bytes / BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def visible_pairs(Sq: int, Skv: int, causal: bool,
                  window: Optional[int]) -> int:
    """(q, k) pairs the masks leave visible, q aligned to the end of kv:
    query i (at position i + Skv - Sq) sees the keys j <= its position
    (causal) within ``window`` of it."""
    total = 0
    for i in range(Sq):
        p = i + Skv - Sq
        hi = min(p, Skv - 1) if causal else Skv - 1
        lo = max(0, p - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def attention_flops(B: int, Hq: int, D: int, Sq: int, Skv: int,
                    causal: bool, window: Optional[int] = None) -> int:
    """QK^T and PV over the visible pairs."""
    return 4 * B * Hq * D * visible_pairs(Sq, Skv, causal, window)


def attention_bytes(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int,
                    itemsize: int = 2) -> int:
    """q, k and v read once, the output (q's shape) written once."""
    return itemsize * D * (2 * B * Hq * Sq + 2 * B * Hkv * Skv)


def ssd_flops(BH: int, S: int, P: int, N: int, chunk: int) -> int:
    """The chunked algorithm's products per chunk: C B^T and (.)X over the
    lower triangle the causal mask keeps, C h and B^T X in full."""
    tri = chunk * (chunk + 1) // 2
    return 2 * BH * (-(-S // chunk)) * (tri * (N + P) + 2 * chunk * N * P)


def ssd_least_flops(BH: int, S: int, P: int, N: int) -> int:
    """The least :func:`ssd_flops` over the chunks a scan could take."""
    return min(ssd_flops(BH, S, P, N, c) for c in SSD_CHUNKS)


def ssd_bytes(BH: int, BG: int, S: int, P: int, N: int) -> int:
    """xdt (BH, S, P) bf16 read and y written, dA (BH, S) f32, B and C
    (BG, S, N) bf16 once a group row."""
    return 2 * (2 * BH * S * P) + 4 * BH * S + 2 * (2 * BG * S * N)


def attention_rows_flops_bytes(Hq: int, Hkv: int, D: int, lengths,
                               window: Optional[int]) -> Tuple[int, int]:
    """(operations, bytes) of a causal launch over rows that each attend
    their own prompt of ``lengths[r]`` tokens: the visible pairs of each
    prompt, and q, k, v read and the output written for its tokens alone.
    A row's padding, and a row with no prompt, are no work."""
    pairs = sum(_pairs(0, n, window) for n in lengths)
    tokens = sum(lengths)
    return 4 * Hq * D * pairs, 2 * D * (2 * Hq * tokens + 2 * Hkv * tokens)


def launch_bound_ms(kind: str, shape: Dict) -> float:
    """The least ms one launch of a kernel at ``shape`` could take
    (``flash_attention_rows``: a launch over the prompts ``lengths``)."""
    if kind == "flash_attention_rows":
        s = shape
        return bound(*attention_rows_flops_bytes(
            s["Hq"], s["Hkv"], s["D"], s["lengths"], s["window"]))[0]
    if kind == "flash_attention":
        s = shape
        return bound(attention_flops(s["B"], s["Hq"], s["D"], s["Sq"],
                                     s["Skv"], s["causal"], s["window"]),
                     attention_bytes(s["B"], s["Hq"], s["Hkv"], s["Sq"],
                                     s["Skv"], s["D"]))[0]
    if kind == "ssd_scan":
        s = shape
        return bound(ssd_least_flops(s["BH"], s["S"], s["P"], s["N"]),
                     ssd_bytes(s["BH"], s["BG"], s["S"], s["P"], s["N"]))[0]
    raise ValueError(f"no count for kernel {kind!r}")


# ------------------------------------------------------------ model FLOPs


def layer_matmul_params(cfg: Dict) -> int:
    """The weights of one decoder layer that multiply each token: the
    attention projections, the SSM mixer's in/out projections and the
    MLP (norms, biases and the conv left out)."""
    d, H, Hkv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    n = d * hd * (H + 2 * Hkv) + H * hd * d
    if cfg.get("ssm_state"):
        di = cfg["ssm_expand"] * d
        ng, ns = cfg["ssm_ngroups"], cfg["ssm_state"]
        nh = di // cfg["ssm_headdim"]
        n += d * (2 * di + 2 * ng * ns + nh) + di * d
    if cfg["d_ff"]:
        n += 3 * d * cfg["d_ff"]
    return n


def padded_vocab(cfg: Dict) -> int:
    m = cfg.get("vocab_pad", 128)
    return -(-cfg["vocab_size"] // m) * m


def _pairs(S_from: int, S_to: int, window: Optional[int]) -> int:
    """Causal visible pairs of the queries at positions [S_from, S_to)
    over the keys before them: position p sees min(p + 1, window)."""
    def upto(n):          # sum over p < n of min(p + 1, window)
        if window is None or n <= window:
            return n * (n + 1) // 2
        return window * (window + 1) // 2 + (n - window) * window
    return upto(S_to) - upto(S_from)


def _ssd_tokens_flops(cfg: Dict, B: int, S: int) -> int:
    if not cfg.get("ssm_state"):
        return 0
    nh = cfg["ssm_expand"] * cfg["d_model"] // cfg["ssm_headdim"]
    return ssd_least_flops(B * nh, S, cfg["ssm_headdim"], cfg["ssm_state"])


def forward_flops(cfg: Dict, B: int, S: int, logits_rows: int) -> int:
    """Model FLOPs of a causal forward over B rows of S tokens: every
    layer's matmuls at each token, attention at its visible pairs, the SSD
    scan's least work, the unembed at ``logits_rows`` positions in all."""
    L, H = cfg["n_layers"], cfg["n_heads"]
    hd = cfg.get("head_dim") or cfg["d_model"] // H
    per_layer = 2 * layer_matmul_params(cfg) * B * S \
        + 4 * H * hd * B * _pairs(0, S, cfg.get("window")) \
        + _ssd_tokens_flops(cfg, B, S)
    return L * per_layer + 2 * cfg["d_model"] * padded_vocab(cfg) * logits_rows


def serve_request_flops(cfg: Dict, prompt: int, decoded: int) -> int:
    """Model FLOPs of one served request: its prompt as sent (unpadded)
    through the prefill, the last position's logits, and ``decoded``
    one-token steps, each over the keys before it, with its logits."""
    L, H = cfg["n_layers"], cfg["n_heads"]
    hd = cfg.get("head_dim") or cfg["d_model"] // H
    w = cfg.get("window")
    prefill = forward_flops(cfg, 1, prompt, 1)
    step = L * (2 * layer_matmul_params(cfg)) \
        + 2 * cfg["d_model"] * padded_vocab(cfg)
    attn = L * 4 * H * hd * _pairs(prompt, prompt + decoded, w)
    ssd = 0
    if cfg.get("ssm_state"):   # the recurrence: state update and read out
        nh = cfg["ssm_expand"] * cfg["d_model"] // cfg["ssm_headdim"]
        ssd = L * 4 * nh * cfg["ssm_state"] * cfg["ssm_headdim"] * decoded
    return prefill + decoded * step + attn + ssd


def train_step_flops(cfg: Dict, B: int, S: int) -> int:
    """Model FLOPs of a training step: 3 x the forward (the backward's two
    products a forward one); the remat recompute is not counted."""
    return 3 * forward_flops(cfg, B, S, B * S)
