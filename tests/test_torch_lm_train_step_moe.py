"""The port's full training step against the JAX package's, for the MoE
(granite-moe-3b-a800m, deepseek-moe-16b) and encoder-decoder
(seamless-m4t-medium) configs, as ``test_torch_lm_train_step.py`` holds
the others; and ``opt_state_from_reference`` leaf by leaf."""

import numpy as np
import pytest
import torch

from repro_torch.convert import (lm_params_from_reference,
                                 opt_state_from_reference)
from torch_lm_train_cases import (
    STEPS, configs, first_step_case, ref_steps, resumed_step_case,
    trainable)

ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b", "seamless-m4t-medium"]


@pytest.mark.parametrize("variant,grad_accum,remat", STEPS,
                         ids=[v for v, _, _ in STEPS])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step(arch, variant, grad_accum, remat):
    first_step_case(arch, variant, grad_accum, remat)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_resumed_from_reference_state(arch):
    resumed_step_case(arch)


def test_opt_state_from_reference_maps_every_leaf():
    _, cfg = configs("granite-moe-3b-a800m")
    (_, o1, _), _ = ref_steps("granite-moe-3b-a800m", 1)
    state = opt_state_from_reference(cfg, o1)
    want = lm_params_from_reference(cfg, o1["mu"])
    assert sorted(state["mu"]) == sorted(state["nu"]) == sorted(want) == \
        sorted(n for n, _ in trainable("granite-moe-3b-a800m")
               .named_parameters())
    for name in want:
        np.testing.assert_array_equal(state["mu"][name].numpy(),
                                      want[name].numpy())
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
