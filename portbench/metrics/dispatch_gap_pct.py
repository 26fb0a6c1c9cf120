"""Share of the traced window's device span with no dispatched step in
flight: CUDA events recorded before and after each dispatch, the gaps
between one dispatch's end and the next one's start over the span from the
first start to the last end."""


def read(ctx):
    ev = [] if ctx.recorder is None else ctx.recorder.events
    if len(ev) < 2:
        return None
    span = ev[0][0].elapsed_time(ev[-1][1])
    gaps = sum(ev[k][1].elapsed_time(ev[k + 1][0]) for k in range(len(ev) - 1))
    return 100.0 * gaps / span
