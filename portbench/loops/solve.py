"""Back-to-back ``solve(SelectionSpec(...))`` calls on one ground set made in
set-up, each picking ``budget`` items with ``optimizer``.

Traffic keys: ``function``, ``optimizer``, ``budget``, ``trace_solves``
(solves in the traced phase) and ``check_solves`` (solves of the window the
reference judges, drawn from the seed).  Where the function holds S,
``CHECK_ROWS`` rows of it, drawn from the seed, are judged too.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import generator, reference

clock = time.perf_counter
CHECK_ROWS = 16  # rows of the resident S compared with the reference


def drive(ctx, seconds, trace, t_start, tracer):
    from repro_torch.core import solve
    from repro_torch.core.optimizers.backends import backend_name

    tr, run = ctx.traffic, generator.Run()
    x = ctx.features
    ctx.sync()
    t_inputs = clock()
    fn, S = ctx.function(x)
    spec = ctx.spec(fn, tr["budget"])
    run.backend = backend_name(fn)
    ctx.sync()
    t_function = clock()
    solve(spec)
    ctx.sync()
    if trace and ctx.device.type == "cuda":
        from portbench.devtrace import warm_up

        warm_up()
    t0 = clock()
    run.setup_s = t0 - t_start
    run.setup_parts = {"start_and_inputs": t_inputs - t_start,
                       "function": t_function - t_inputs, "warm_up": t0 - t_function}
    results = []
    while True:
        res = solve(spec)
        results.append((res.order.cpu().tolist(), res.gains.cpu().tolist()))
        t = clock()
        if t - t0 >= seconds:
            break
    run.window_s, run.solves = t - t0, len(results)
    run.attempted = run.solves
    if trace:
        with tracer() as tc:
            for _ in range(tr["trace_solves"]):
                solve(spec)
        run.trace = tc.summary
        run.trace_steps = tr["trace_solves"] * tr["budget"]
        run.trace_work_s = run.trace_steps * ctx.function_module.step_s(ctx.config)
    ctx.sync()
    run.memory_peak_bytes = ctx.peak()
    picks = ctx.rng.choice(len(results), size=min(tr["check_solves"], len(results)),
                           replace=False)
    answers = [_answer(x, ctx.metric, tr["budget"], *results[int(i)]) for i in picks]
    if S is not None:
        _sample_rows(ctx, answers[0], S)
    return run, answers


def control_answers(ctx, names) -> list:
    """The control's answer to the same inputs, in the program's place."""
    x = ctx.features
    budget = ctx.traffic["budget"]
    ids, gains, S = ctx.function_module.control(x, ctx.config, budget)
    a = reference.Answer(x=x, metric=ctx.metric, budget=budget, ids=ids, gains=gains)
    if set(reference.SIM_NUMBERS) & set(names):
        _sample_rows(ctx, a, S)
    return [a]


def _sample_rows(ctx, a: reference.Answer, S: torch.Tensor) -> None:
    rows = np.sort(ctx.rng.choice(ctx.n, CHECK_ROWS, replace=False))
    a.sim_rows = torch.as_tensor(rows, device=S.device)
    a.sim_values = S[a.sim_rows].clone()


def _answer(x, metric, budget, order, gains) -> reference.Answer:
    keep = [i for i, j in enumerate(order) if j >= 0]
    return reference.Answer(x=x, metric=metric, budget=budget,
                            ids=[int(order[i]) for i in keep],
                            gains=[float(gains[i]) for i in keep])
