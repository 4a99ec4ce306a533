"""update_ms: the mean host ms a frame spends in the scene update
(`Composition.set_transforms` or `Layer.set_transform`), a host-clock
span in the harness around the calls, over the window's frames.  Nothing
where the mix updates nothing."""


def read(ctx):
    if not ctx.update_s:
        return None
    return 1e3 * sum(ctx.update_s) / len(ctx.update_s)
