"""Set-up: from the start of the process to the start of the window
(imports, kernel build or load, weights, warm-up), host clock."""


def read(run):
    return run.setup_s
