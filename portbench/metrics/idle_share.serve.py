"""idle_share: the share of the traced stretch with no device operation
running (the union of their intervals), in %."""
import harness


def read(record):
    return harness.idle_pct(record)
