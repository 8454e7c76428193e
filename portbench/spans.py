"""Stage spans of the traced run: the four stage functions wrapped at the
names by which ``zultra_tpu_torch.device_pipeline`` calls them.

Each span is ``torch.cuda.synchronize()`` on both sides and the host
clock between (as zultra_tpu_torch/profile_stages.py ``_timed``), and a
``torch.profiler.record_function`` range named ``portbench.<stage>`` so
the trace can tell what the host was doing while the device idled. A
stage whose name the module lacks is left out; its metric then reads
nothing.
"""

from __future__ import annotations

import time

STAGES = ("match_stacks", "split_batch", "plan_blocks_device_multi", "emit_window_from_plan")


class Spans:
    def __init__(self, module, sync):
        self.module = module
        self.sync = sync
        self.seconds = {}  # stage -> seconds, for the stages found
        self.dp_positions = 0  # positions of every lane the block plans were given
        self._saved = []

    def install(self) -> None:
        for name in STAGES:
            fn = getattr(self.module, name, None)
            if fn is not None:
                self._saved.append((name, fn))
                self.seconds[name] = 0.0
                setattr(self.module, name, self._wrap(name, fn))

    def remove(self) -> None:
        for name, fn in self._saved:
            setattr(self.module, name, fn)
        self._saved = []

    def _wrap(self, name, fn):
        from torch.profiler import record_function

        def wrapper(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            with record_function("portbench." + name):
                out = fn(*args, **kwargs)
                self.sync()
            self.seconds[name] += time.perf_counter() - t0
            if name == "plan_blocks_device_multi":
                lanes = kwargs["lanes"] if "lanes" in kwargs else args[3]
                self.dp_positions += sum(int(lane[2]) for lane in lanes)
            return out

        return wrapper
