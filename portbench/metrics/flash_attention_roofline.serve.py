"""flash_attention_roofline: the FlashAttention kernel's launches in the
traced stretch, each counted at the work its prefill needed (the frozen
count over the prompts its rows held, padding left out), over their
device time, in %."""
import harness


def read(record):
    return harness.calls_roofline_pct(record, "flash_attention_rows",
                                      ("fa_fwd",), "fa_calls")
