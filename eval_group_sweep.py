#!/usr/bin/env python3
"""Time `evaluate_model` over a bank of 300 ResNet-20 samples on one NVIDIA
GPU, at several sample-group sizes (`evaluate.metrics.SAMPLE_GROUP`: the
samples that one network pass carries).

    python3 eval_group_sweep.py

The bank has the paper's size (it keeps 300 samples): a He-initialised
ResNet-20 whose parameters and batchnorm buffers get seeded perturbations
a sample. The test set is fake_cifar10's 10,000 points in batches of 512,
`eval_bnn`'s default, in float32 with TF32 off. Each group size is timed in
two turns (the sizes in order, then in reverse), each call between two
device synchronisations, and every size must give the first one's result
within rtol 1e-5. It prints the card's name and power limit, a line per
call, and one JSON line of the median seconds a group size.
"""
import json
import time

import numpy as np
import torch

import chip_smoke as cs

SAMPLES = 300
GROUPS = (1, 4, 8, 16, 32)


def make_bank(model, n, seed=0):
    "n samples: the model's state with seeded perturbations, numpy f32"
    rng = np.random.RandomState(seed)
    base = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    bank = {}
    for k, v in base.items():
        if v.dtype.kind != "f":
            bank[k] = np.repeat(v[None], n, axis=0)
            continue
        noise = rng.standard_normal((n,) + v.shape).astype(np.float32)
        if k.endswith("running_var"):
            bank[k] = v * np.exp(0.1 * noise)
        else:
            bank[k] = v + 0.1 * (v.std() + 1e-3) * noise
    return bank


def main():
    if not torch.cuda.is_available():
        print("eval_group_sweep: no CUDA device")
        return 1
    from bnn_priors_tpu_torch.data import FakeCIFAR10
    from bnn_priors_tpu_torch.evaluate import metrics
    from bnn_priors_tpu_torch.exp_utils import get_model, he_initialize
    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = FakeCIFAR10(n_train=128, n_test=10000)
    x, y = data.norm.test
    model = get_model("googleresnet")
    he_initialize(model, torch.Generator().manual_seed(1))
    bank = make_bank(model, SAMPLES)
    print(f"bank: {SAMPLES} samples, {sum(v.nbytes for v in bank.values()) / 1e6:.1f} MB; "
          f"test set {x.shape[0]} points in batches of 512")

    def evaluate(group, samples):
        metrics.SAMPLE_GROUP = group
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = metrics.evaluate_model(model, (x, y), samples, batch_size=512)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    small = {k: v[:2 * max(GROUPS)] for k, v in bank.items()}
    for g in GROUPS:  # warm-up: every group's shapes once
        evaluate(g, small)
    seconds = {g: [] for g in GROUPS}
    ref = None
    for g in GROUPS + GROUPS[::-1]:
        s, res = evaluate(g, bank)
        ref = ref or res
        for k, v in ref.items():
            cs.check(np.isclose(res[k], v, rtol=1e-5, atol=0),
                     f"group {g}: {k} {res[k]} vs {v}")
        seconds[g].append(s)
        print(f"evaluate_model, {SAMPLES} samples x {x.shape[0]} points, "
              f"group {g:2d}: {s:.3f} s ({1e3 * s / SAMPLES:.2f} ms a sample)"
              f" on {card}; {json.dumps(res)}")
    print(json.dumps({"samples": SAMPLES, "points": int(x.shape[0]),
                      "seconds": {g: float(np.median(v))
                                  for g, v in seconds.items()},
                      "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
