"""engine_host_ms.serve: the window's time outside ``Model.prefill`` and
``Model.decode`` (their spans on the device), per decode step of the
window, in ms."""


def read(record):
    steps = record.counters.get("window_decode_steps")
    pre, dec = record.spans.get("prefill"), record.spans.get("decode")
    if not steps or not dec:
        return None
    return 1e3 * (record.window_s - sum(pre or []) - sum(dec)) / steps
