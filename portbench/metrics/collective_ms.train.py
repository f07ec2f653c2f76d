"""collective_ms.train: the ``params/`` and ``grads/`` collectives' ms a
step of the window (``record_collectives(timed=True)``: CUDA events
around each call), the highest over the ranks."""


def read(record):
    return record.counters.get("collective_ms")
