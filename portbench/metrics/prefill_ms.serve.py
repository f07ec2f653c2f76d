"""prefill_ms.serve: the median of the window's ``Model.prefill`` calls,
each timed on the device by the harness's span, in ms."""
import statistics


def read(record):
    xs = record.spans.get("prefill")
    return 1e3 * statistics.median(xs) if xs else None
