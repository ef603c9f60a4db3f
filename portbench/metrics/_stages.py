"""Shared by the stage and span readers: the mean over the window's
requests of the seconds of some stages or spans, None where no request
had any of them."""


def mean_stages(ctx, names):
    if not any(n == s for r in ctx.requests for s, _, _ in r.stages
               for n in names):
        return None
    return sum(r.stage_seconds(n) for r in ctx.requests
               for n in names) / len(ctx.requests)


def mean_spans(ctx, names):
    if not any(n in r.spans for r in ctx.requests for n in names):
        return None
    return sum(r.spans.get(n, 0.0) for r in ctx.requests
               for n in names) / len(ctx.requests)
