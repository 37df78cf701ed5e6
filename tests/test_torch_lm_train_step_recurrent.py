"""The port's full training step against the JAX package's, for
xlstm-1.3b (its reduced config's eight layers make the largest
reference program), as ``test_torch_lm_train_step.py`` holds the
others."""

import pytest

from torch_lm_train_cases import STEPS, first_step_case, resumed_step_case

ARCHS = ["xlstm-1.3b"]


@pytest.mark.parametrize("variant,grad_accum,remat", STEPS,
                         ids=[v for v, _, _ in STEPS])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step(arch, variant, grad_accum, remat):
    first_step_case(arch, variant, grad_accum, remat)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_resumed_from_reference_state(arch):
    resumed_step_case(arch)
