"""Share of the traced window in which no operation ran on the card
(from the device events of ``torch.profiler``), in %."""


def read(run):
    if not run.window_s or run.busy_s is None:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
