"""The share of the server's batch slots that served an order, %: tiles
served over batches × ``batch_size``, from ``TileServer.served`` and
``.batches`` over the window (a short batch is padded with repeats,
wasted work)."""


def read(tr):
    c = tr.counters
    if not c.get("batches"):
        return None
    return 100.0 * c["served"] / (c["batches"] * c["batch_size"])
