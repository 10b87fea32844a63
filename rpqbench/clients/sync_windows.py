"""Client ``sync_windows``: a closed loop over the sync API.  It enqueues
the mix's ``window`` requests, flushes, and reads their tickets, over and
over: each client waits for its answer before it sends again.  Every
``enqueue`` also gets the mix's ``enqueue`` keyword arguments
(``semantics``, ``strategy``), if it has them.

The measured window runs until ``seconds`` have passed and it has served
a whole number of the mix's ``block``s, so that every run of a cell
serves the same requests, block by block, in another order."""


def check(mix: dict) -> None:
    if mix["block"] % mix["window"] or mix["warmup"] % mix["block"]:
        raise ValueError("sync_windows needs window | block | warmup, so that the window ends on a block")


def _serve(svc, reqs: list, mix: dict) -> list:
    kw = mix.get("enqueue", {})
    tickets = [svc.enqueue(q, s, **kw) for q, s in reqs]
    svc.flush()
    return [(q, s, t) for (q, s), t in zip(reqs, tickets)]


def warmup(svc, reqs: list, mix: dict) -> None:
    for lo in range(0, len(reqs), mix["window"]):
        _serve(svc, reqs[lo : lo + mix["window"]], mix)


def drive(svc, stream, mix: dict, seconds: float, clock) -> tuple[list, list]:
    """The measured window: every (query, starts, ticket) it served, and
    each flush as (host seconds, its requests' first index, their count)."""
    done, flushes = [], []
    t0 = clock()
    while clock() - t0 < seconds or len(done) % mix["block"]:
        t = clock()
        part = _serve(svc, [next(stream) for _ in range(mix["window"])], mix)
        flushes.append((clock() - t, len(done), len(part)))
        done += part
    return done, flushes
