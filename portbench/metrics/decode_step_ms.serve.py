"""decode_step_ms.serve: the median of the window's ``Model.decode``
calls, each timed on the device by the harness's span, in ms."""
import statistics


def read(record):
    xs = record.spans.get("decode")
    return 1e3 * statistics.median(xs) if xs else None
