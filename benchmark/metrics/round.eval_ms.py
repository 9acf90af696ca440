"""Policy loop: the mean ``eval`` span a round, in ms: the measured window's
total of the session's own ``WallClock`` span (``Session.timers``, which
the harness reads from each visit's session) over the rounds counted."""


def read(r):
    return r.get("round_eval_ms")
