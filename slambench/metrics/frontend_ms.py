"""Mean host-clock span of the calls into the frontend layer over the traced
window, each span synchronized at both ends; None where the window made no
such call."""


def read(ctx):
    s = ctx.get("spans", {}).get("frontend")
    return 1e3 * sum(s) / len(s) if s else None
