"""Host milliseconds a window step spends in the engine's own work: the
`engine.host_us` laps (telemetry on) of schedule, upload, launch and
bookkeeping, not copy_back, which holds the wait for the device."""

PARTS = ("schedule", "upload", "launch", "bookkeeping")


def read(run):
    steps = len(run.step_ends)
    if not steps or not run.host_us:
        return None
    return sum(run.host_us.get(p, 0.0) for p in PARTS) / steps / 1e3
