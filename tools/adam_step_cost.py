#!/usr/bin/env python3
"""The cost of the port's Adam against torch's on the card.

  python3 tools/adam_step_cost.py

Two full-width f32 states (256^2, batch 1, health on) from one seed, one
with ``CapturableAdam`` (the count on the device, optax's arithmetic) and
one with torch's ``Adam`` (its default, foreach, count on the host); after
3 untimed steps each, 8 rounds in turns of one train step (host clock,
synchronized) and of the four optimizers' steps alone on zero gradients
(host time to enqueue, and with the card's finish). Prints the medians.
Needs a card.
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from cyclegan_tpu_torch.config import (  # noqa: E402
    KERNEL_LAYOUT,
    Config,
    ModelConfig,
)
from cyclegan_tpu_torch.models.generator import use_full_fp32  # noqa: E402
from cyclegan_tpu_torch.train.state import ADAM_EPS, create_state  # noqa: E402
from cyclegan_tpu_torch.train.steps import make_train_step  # noqa: E402


def main() -> None:
    use_full_fp32()
    dev = torch.device("cuda", 0)
    cfg = Config(model=ModelConfig(**KERNEL_LAYOUT))
    x = torch.rand(1, 256, 256, 3, device=dev) * 2 - 1
    w = torch.ones(1, device=dev)
    states = {cap: create_state(cfg, 0, dev) for cap in (False, True)}
    # The comparison's torch Adam, built here: the port has none.
    ref, hp = states[False], cfg.optimizer
    ref.g_opt, ref.f_opt, ref.dx_opt, ref.dy_opt = (
        torch.optim.Adam(net.parameters(), lr=hp.learning_rate,
                         betas=(hp.b1, hp.b2), eps=ADAM_EPS)
        for net in ref.networks)
    step = make_train_step(cfg, 1)
    for s in states.values():
        for _ in range(3):
            step(s, x, x, w)
    torch.cuda.synchronize()
    steps = {False: [], True: []}
    opt = {False: [], True: []}
    for r in range(8):
        for cap in ((False, True) if r % 2 == 0 else (True, False)):
            s = states[cap]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(s, x, x, w)
            torch.cuda.synchronize()
            steps[cap].append((time.perf_counter() - t0) * 1e3)
            for net in s.networks:
                for p in net.parameters():
                    p.grad = torch.zeros_like(p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for o in s.optimizers:
                o.step()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            opt[cap].append(((t1 - t0) * 1e3,
                             (time.perf_counter() - t0) * 1e3))
            for o in s.optimizers:
                o.zero_grad(set_to_none=True)
    for cap, name in ((True, "CapturableAdam"), (False, "torch Adam")):
        print(f"{name}: train step {statistics.median(steps[cap]):.2f} ms "
              f"(median of 8), four optimizer steps "
              f"{statistics.median(a for a, _ in opt[cap]):.2f} ms to "
              f"enqueue, {statistics.median(b for _, b in opt[cap]):.2f} ms "
              "with the card's finish", flush=True)


if __name__ == "__main__":
    main()
