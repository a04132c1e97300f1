"""``phase_us.wake_sample``: device us a slot of the slot's prefix up to its
wake sampling (the draws, churn and the compaction), from the engine's own
phase program (``AsyncEngine.phase_program("wake_sample")``), best of 3."""


def read(ctx):
    ph = ctx["phases"]
    if not ph or "wake_sample" not in ph:
        return None
    return ph["wake_sample"] * 1e6
