"""trainer.val_share: the share of the window spent in ``evaluate("val")``,
by the host clock (each pass ends in reading its losses, which waits for
the card)."""


def read(run):
    return sum(e["val_s"] for e in run["epochs"]) / run["window_s"]
