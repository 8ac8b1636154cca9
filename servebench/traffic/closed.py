"""Closed loop: N clients, each sending its next request when its last one
has been answered.

Callers that each wait for a reply, as an agent or a batch job does: a slow
server gets less load. A request is measured when it is sent inside the
window, and its time to first token counts from when it was sent. The
clients start a fraction of a second apart, and the warm-in spreads them
further. Each client cycles through a stratified pool of sizes
(`sizes.py`) in an order of its own, with fresh prompt ids every time.
After the window the clients keep sending until every window request has
finished. The mix gives "clients", "prompt" and "budget".
"""

import random
import threading
import time

POOL = 64  # sizes a client draws before it repeats its pool
STAGGER_S = 1.0  # the clients' first requests go out over this span


def prepare(plan: dict, sizes) -> dict:
    mix = plan["mix"]
    clients = []
    for c in range(int(mix["clients"])):
        rng = random.Random(f"{plan['seed']}:closed:{c}")
        clients.append((rng, sizes.pool(mix["prompt"], POOL, rng),
                        sizes.pool(mix["budget"], POOL, rng)))
    return {"clients": clients}


def _client(ctx, start: int, rng, lens, budgets) -> None:
    ctx.sleep_until(start)
    j = 0
    while not ctx.finished():
        n, b = lens[j % POOL], budgets[j % POOL]
        j += 1
        prompt = ctx.prompt(rng, n)
        ctx.send(prompt, b, ctx.phase(time.monotonic_ns()), None)


def drive(ctx, state: dict, sizes) -> None:
    """Start the clients' threads and return; the client process waits for
    ctx.finished()."""
    clients = state["clients"]
    for c, (rng, lens, budgets) in enumerate(clients):
        start = ctx.t0 + int(STAGGER_S * 1e9 * c / len(clients))
        threading.Thread(target=_client, args=(ctx, start, rng, lens, budgets),
                         daemon=True).start()
