"""mfu: the window's model FLOPs (the frozen count: every matmul at the
tokens processed, attention at its visible pairs; training 3x the
forward) over the window times the chips' bf16 peak, in %."""
import harness


def read(record):
    return harness.mfu_pct(record)
