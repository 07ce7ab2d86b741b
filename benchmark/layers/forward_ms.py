"""forward_ms: mean device ms of a graphed replay of the cell's forward and
loss alone (CUDA events around each replay; fit cells)."""


def read(data):
    return data.get("forward_ms")
