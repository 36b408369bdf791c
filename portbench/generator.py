"""The one general generator: it reads a cell's configuration and traffic
files, makes the inputs from the seed, and drives the program through the
loop the traffic names.

Two keys of the traffic file name files of their own, found by name:

- ``loop``: ``portbench/loops/<loop>.py``, whose ``drive(ctx, seconds,
  trace, t_start, tracer)`` runs set-up, the measured window and, with
  ``trace``, a traced phase after it, and returns the :class:`Run` and the
  answers to judge; its ``control_answers(ctx, names)`` answers the same
  inputs with the control in the program's place (``portbench/calibrate.py``);
- ``function``: ``portbench/functions/<function>.py``, the function of the
  configuration's ``family`` as the program builds it (``FAMILY``,
  ``build(x, config)``), the least time of one greedy step over it
  (``step_s(config)``), its plain reference's comparison (``judge``) and
  the control (``control(x, config, budget)``).

A cell of an existing loop and function is added by data files alone.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import torch

from portbench.devtrace import DeviceTrace


def plugin(root: Path, folder: str, name: str):
    """The module ``portbench/<folder>/<name>.py`` under ``root``."""
    path = Path(root) / "portbench" / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder} file named {name!r} ({path})")
    tag = "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """What one run measured: the readers of ``portbench/metrics`` read it."""

    setup_s: float = math.nan
    window_s: float = math.nan
    solves: int = 0  # solves completed in the window
    attempted: int = 0
    failed: int = 0
    trace: object = None  # TraceSummary of the traced phase
    trace_steps: int = 0  # greedy steps required in the traced phase
    trace_work_s: float = 0.0  # least time of the work required in the traced phase
    memory_peak_bytes: int = 0
    backend: str = ""
    setup_parts: dict = dataclasses.field(default_factory=dict)  # seconds, host clock
    judged: int = 0  # answers the reference judged, after the window
    judge_s: float = 0.0  # the reference's time (host clock)

    def idle_pct(self):
        if self.trace is None:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def roofline_pct(self):
        if self.trace is None or self.trace_work_s <= 0.0:
            return None
        return 100.0 * self.trace_work_s / self.trace.busy_s


def mixture(gen, n: int, d: int, components: int, device) -> torch.Tensor:
    """(n, d) fp32 rows of a seeded Gaussian mixture made on the device:
    ``components`` centres and the noise N(0, 1) (``chip_smoke.py``'s
    generator)."""
    centres = torch.randn((components, d), generator=gen, device=device)
    labels = torch.randint(0, components, (n,), generator=gen, device=device)
    return torch.randn((n, d), generator=gen, device=device) + centres[labels]


class Context:
    """One run's inputs, made from the seed, and its handles on the program."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, root: Path):
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.root = Path(root)
        self.function_module = plugin(self.root, "functions", traffic["function"])
        if config["family"] != self.function_module.FAMILY:
            raise KeyError(f"function {traffic['function']!r} builds "
                           f"{self.function_module.FAMILY}, not {config['family']}")
        self.seed = int(seed) & (2**63 - 1)
        self.rng = np.random.default_rng(self.seed)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.n, self.d, self.metric = config["n"], config["d"], config["metric"]
        self.features = mixture(self.gen, self.n, self.d, config["data"]["components"],
                                self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def function(self, x: torch.Tensor):
        """(the program's function over the rows x, its S or None)."""
        return self.function_module.build(x, self.config)

    def spec(self, fn, budget: int):
        from repro_torch.core import SelectionSpec

        return SelectionSpec(fn, int(budget), self.traffic["optimizer"])

    def loop(self):
        return plugin(self.root, "loops", self.traffic["loop"])


def drive(ctx: Context, seconds: float, trace: bool, t_start: float, tracer=DeviceTrace):
    """Run the cell's loop; returns the Run and the answers to judge."""
    return ctx.loop().drive(ctx, seconds, trace, t_start, tracer)
