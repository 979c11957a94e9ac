"""The paged engine's admission deferrals (its `deferrals` counter: the
head of the queue did not fit the free pages while a slot was free) for
every 1,000 admissions in the window."""


def read(run):
    admissions = run.window.get("admissions")
    if not admissions:
        return None
    return 1e3 * run.window["deferrals"] / admissions
