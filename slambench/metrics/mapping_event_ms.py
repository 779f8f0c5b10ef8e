"""Mean host-clock span of the calls into the mapping step (one a mapping
event) over the traced window, each span synchronized at both ends; None
where the window mapped nothing."""


def read(ctx):
    s = ctx.get("spans", {}).get("mapping_event")
    return 1e3 * sum(s) / len(s) if s else None
