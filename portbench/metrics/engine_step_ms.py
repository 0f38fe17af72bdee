"""The host time of the engine's ``step()`` calls begun in the window,
over their number, in ms (``step()`` ends in its token fetch)."""


def read(rec):
    steps = rec.get("steps")
    if rec.get("kind") != "serve" or not steps:
        return None
    return 1e3 * sum(steps) / len(steps)
