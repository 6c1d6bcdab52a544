"""setup_s: seconds from the process's start to the first timed
operation (imports, scene build, the program's set-up, warm-up)."""


def read(run):
    return run.setup_s
