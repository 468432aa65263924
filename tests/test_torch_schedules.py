"""The port's LR schedules (`adaface_tpu_torch/training/schedules.py`)
against `adaface_tpu/training/schedules.py`, steps 0..49, each schedule
kind, on Python ints, a numpy array and a torch tensor; float32 on both
sides, so the values agree to 1e-6."""

import numpy as np
import pytest
import torch

from adaface_tpu.training import schedules as jsched

from adaface_tpu_torch.training import schedules as tsched

STEPS = np.arange(50)
CASES = {
    "warmup cosine": ("lambda_warmup_cosine", dict(warm_up_steps=10, lr_min=0.1, lr_max=1.0,
                                                   lr_start=1e-3, max_decay_steps=40)),
    "linear": ("prodigy_cycle_schedule", dict(warm_up_steps=5, max_steps=50,
                                              scheduler_type="Linear", num_cycles=2)),
    "cosine restarts": ("prodigy_cycle_schedule",
                        dict(warm_up_steps=5, max_steps=50,
                             scheduler_type="CosineAnnealingWarmRestarts", num_cycles=3)),
    "cyclic": ("prodigy_cycle_schedule", dict(warm_up_steps=0, max_steps=50,
                                              scheduler_type="CyclicLR", num_cycles=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_jax(case):
    name, kw = CASES[case]
    want = np.asarray([float(getattr(jsched, name)(**kw)(int(s))) for s in STEPS])
    port = getattr(tsched, name)(**kw)
    scalars = np.asarray([float(port(int(s))) for s in STEPS])
    np.testing.assert_allclose(scalars, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port(STEPS), want, rtol=0, atol=1e-6)
    t = port(torch.as_tensor(STEPS))
    assert torch.is_tensor(t) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), want, rtol=0, atol=1e-6)
    assert len(np.unique(np.round(want, 6))) > 5  # the schedule moves


def test_unknown_kind_raises():
    with pytest.raises(NotImplementedError):
        tsched.prodigy_cycle_schedule(0, 10, scheduler_type="Step")
