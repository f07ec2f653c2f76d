"""flash_attention_roofline: the FlashAttention kernel's launches in the
traced stretch times the least time one launch at the cell's shape could
take (the frozen count), over their device time, in %."""
import harness


def read(record):
    return harness.roofline_pct(record, "flash_attention", ("fa_fwd",),
                                "fa_shape")
