"""What the per-layer metrics read: one traced window's device operations,
the loop that drove it, and the index kernels' bytes.
Each metric's own file (`portbench/layer_metrics/<name>.py`) takes its
number from a `Context` and returns None where the window has nothing for
it to read."""
from __future__ import annotations

import re

from portbench import roofline


class Context:
    def __init__(self, torch, window, trace, loop, device_name: str):
        self.torch, self.window, self.trace, self.loop = torch, window, trace, loop
        self.device_name = device_name
        self._op_bytes = None

    @property
    def answered(self) -> int:
        return self.window.answered_in_window()

    def kernels(self, name: str | None = None) -> list:
        """The window's kernels, or those of one hand-written kernel
        (`probe_gather_kernel`, `searchsorted_kernel`) by its name."""
        ks = self.trace.kernels()
        if name is None:
            return ks
        pat = re.compile(rf"\b{name}\b")
        return [k for k in ks if pat.search(k[0])]

    def idle_share(self) -> float:
        return 100.0 * (1.0 - self.trace.busy_s() / self.trace.window_s)

    def op_bytes(self) -> dict | None:
        """{op: bytes} the index kernels' calls of the window need, where
        the mix can count them after the window (None otherwise)."""
        if self._op_bytes is None and hasattr(self.loop, "op_bytes"):
            self._op_bytes = self.loop.op_bytes(self.window, self.torch)
        return self._op_bytes

    def roofline(self, op: str) -> float | None:
        """The op's kernel time against the least time its bytes need at
        the card's peak bandwidth, in %."""
        nbytes = (self.op_bytes() or {}).get(op, 0)
        secs = sum(k[3] for k in self.kernels(f"{op}_kernel")) / 1e9
        if nbytes <= 0 or secs <= 0:
            return None
        bound = nbytes / roofline.hbm_bytes_per_s(self.device_name)
        return 100.0 * bound / secs
