"""Share of the window the host spent in the policy calls (the harness's
span around the controller, ended by a device sync), in percent."""


def read(ctx):
    return 100.0 * ctx.policy_s / ctx.window_s
