"""Host wall of the paged engine's decode windows (`_window`, each ending
in its tokens' copy to the host) over the decode steps they ran, ms."""


def read(run):
    steps = run.window.get("steps")
    if not steps:
        return None
    return 1e3 * run.window["window_s"] / steps
