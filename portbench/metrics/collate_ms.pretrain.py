"""Host milliseconds the collator took a batch, over every batch of the
window (the harness's clock around the program's batch iterator)."""


def read(run):
    steps = run.window.get("steps")
    if not steps:
        return None
    return 1e3 * run.window["collate_s"] / steps
