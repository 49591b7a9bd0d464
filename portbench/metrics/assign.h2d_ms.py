"""Milliseconds per analysis of host-to-device copies on the card (the AF
panel's upload), from the traced window."""


def read(run):
    if run.trace is None or not run.analyses:
        return None
    seconds = run.trace.seconds("gpu_memcpy", "HtoD")
    return 1e3 * seconds / run.analyses if seconds > 0 else None
