"""densify_ms.train (trainer): what a densify event adds to its window.

From the host clock at each window log of ``Trainer.train`` (each follows a
sync): the mean, over the windows that end at a densify event, of the
window's time less the mean time of the event-free windows with as many
steps.  Moves ``train_it_per_s``."""

from collections import defaultdict
from statistics import mean


def read(ctx):
    plain, events = defaultdict(list), []
    for steps, seconds, event in ctx.get("windows", ()):
        (events.append((steps, seconds)) if event
         else plain[steps].append(seconds))
    diffs = [s - mean(plain[n]) for n, s in events if plain[n]]
    return 1e3 * mean(diffs) if diffs else None
