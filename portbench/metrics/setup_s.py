"""Set-up: process start until the window opens (loading, weights, the
scene, the map or the checked steps, kernel builds and warm-up)."""


def read(run):
    return run.setup_s
