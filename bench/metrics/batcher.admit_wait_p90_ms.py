"""batcher.admit_wait_p90_ms: 90th percentile, over every request whose
first token came in the window (the requests of ttft_p90_ms), of the time
from its submission to the start of its admission (the batcher's own
`Request.submitted` and `Request.admitted` stamps, both on the host's
clock; on a card `admitted` is when the device's stream reached the
admission, read from an event): the wait in the queue behind the
iteration's token loop and the admissions before it in slot order, on the
card and on the host.  Nothing to read where the program does not stamp
its requests.  Moves ttft_p90_ms."""

from bench import e2e


def read(run):
    loop = run.loop
    waits = []
    for s in loop.served:
        if not (s.iters and loop.in_window(s.iters[0])):
            continue
        sub = getattr(s.request, "submitted", None)
        adm = getattr(s.request, "admitted", None)
        if sub is None or adm is None:
            return None
        waits.append(adm - sub)
    return e2e.p90(waits) * 1e3 if waits else None
