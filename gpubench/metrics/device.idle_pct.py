"""Share of the traced pass in which no operation ran on a card (100 less
the union of the card's kernel, copy and set intervals), the mean over the
cell's cards."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["busy_s"]:
        return None
    cards = range(max(1, sum(str(d).startswith("cuda") for d in ctx["devices"])))
    busy = [tr["busy_s"].get(i, 0.0) for i in cards]
    return 100.0 * (1.0 - sum(busy) / len(busy) / tr["window_s"])
