"""step_ms.train: the median of the window's training steps, CUDA events
around each call of the step function, in ms."""
import statistics


def read(record):
    xs = record.spans.get("step")
    return 1e3 * statistics.median(xs) if xs else None
