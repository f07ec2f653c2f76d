"""plan_warmup_s: seconds the program's plan path took to warm the cell's
kernel plans in set-up (``ServeEngine.stats``, or the harness's clock
around ``launch.train.warmup_kernel_plans``)."""


def read(record):
    return record.counters.get("plan_warmup_s")
