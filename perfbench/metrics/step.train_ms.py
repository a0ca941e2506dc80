"""step.train_ms: the window's train-epoch wall time over its train steps,
in ms (an epoch ends in reading its losses, which waits for the card)."""


def read(run):
    steps = sum(e["train_steps"] for e in run["epochs"])
    return 1e3 * sum(e["train_s"] for e in run["epochs"]) / steps if steps else None
