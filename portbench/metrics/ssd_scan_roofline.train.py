"""ssd_scan_roofline.train: the SSD scan kernel's launches in the traced
stretch times the least time one launch at the cell's shape could take
(the frozen count), over their device time, in %."""
import harness


def read(record):
    return harness.roofline_pct(record, "ssd_scan", ("ssd_fwd",),
                                "ssd_shape")
