"""Stage timing around device work (``gsplat_tpu/utils/timer.py``).

:class:`StageTimer` brackets a stage and records its interval under a name
in a class-level recorder: with CUDA events on a CUDA device (the time the
stream spends between the two events; reading it synchronises with the
second event), with ``time.perf_counter`` on the CPU.  ``trace_if`` wraps a
``torch.profiler`` trace of the CPU and the card.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch


class StageTimer:
    recorder = defaultdict(list)

    def __init__(self, des: str = "", debug: bool = True, device=None):
        self.des = des
        self.debug = debug
        self.cuda = torch.device(device).type == "cuda" \
            if device is not None else False

    def __enter__(self):
        if self.debug:
            if self.cuda:
                self._events = [torch.cuda.Event(enable_timing=True)
                                for _ in range(2)]
                self._events[0].record()
            else:
                self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.debug:
            return
        if self.cuda:
            self._events[1].record()
            self._events[1].synchronize()
            self.interval = self._events[0].elapsed_time(self._events[1]) \
                / 1e3
        else:
            self.interval = time.perf_counter() - self.start
        StageTimer.recorder[self.des].append(self.interval)

    @classmethod
    def means(cls) -> dict:
        """Mean seconds per stage."""
        return {k: float(np.mean(v)) for k, v in cls.recorder.items()}

    @classmethod
    def show_recorder(cls):
        from pprint import pprint

        pprint(cls.means())

    @classmethod
    def reset(cls):
        cls.recorder = defaultdict(list)


class trace_if:
    """``with trace_if(path):`` records a ``torch.profiler`` trace of the CPU
    and, where there is one, the card, written as a Chrome trace to
    ``path``; no-op without a path."""

    def __init__(self, trace_path=None):
        self.trace_path = trace_path
        self.prof = None

    def __enter__(self):
        if self.trace_path:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
            self.prof.export_chrome_trace(self.trace_path)
