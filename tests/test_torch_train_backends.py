"""The other training backends (`xla`, `fused`, `fused_mlp`) and
int8-forward, on the CPU against gtax: dit_apply's gradients against
jax.grad of gtax's dit_apply under the same backend, and one Trainer step
each against gtax's Trainer over the same weights and the same injected
loss noise (test_torch_train_modes.py's helpers).

Tolerances: the gradients at test_torch_train.py's (atol 1e-4 of a leaf's
largest magnitude, rtol 5e-4); the Trainer steps at
test_torch_train_modes.py's (the loss to 1e-5, the gradient norm to 1e-4,
under int8-forward to 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.models import dit as jdit
from gtax.nn import attention as jattn
from gtax_torch.models import dit as tdit
from tests.test_torch_train import (  # noqa: F401 (autouse fixture)
    B, JCFG, T, TCFG, _check_grads, _random_params, _requires_grad,
    _torch_params, interpret_mode)
from tests.test_torch_train_modes import (  # noqa: F401 (fixture)
    _steps_against_gtax, gtax_globals)

torch.set_num_threads(2)


@pytest.mark.parametrize("backend", ["xla", "fused", "fused_mlp"])
def test_dit_apply_gradient_matches_jax_grad_other_backends(backend):
    """The other training backends: dit_apply's gradient against jax.grad
    of gtax's dit_apply under the same backend (`xla`: every branch
    unfused; `fused`: fused attention, unfused MLP; `fused_mlp`: the
    reverse), at the tolerances of the module docstring."""
    r = np.random.default_rng(11)
    jp = _random_params(12)
    x = r.standard_normal((B, T, 8, 6, 8)).astype(np.float32)
    t = r.integers(0, 1000, (B, T)).astype(np.int32)
    a = r.standard_normal((B, T, 25)).astype(np.float32)
    ct = r.standard_normal((B, T, 8, 6, 8)).astype(np.float32)
    valid = np.array([False, False, True, True, True])

    def jloss(p):
        v = jdit.dit_apply(p, JCFG, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(a), jnp.asarray(valid),
                           compute_dtype=jnp.float32)
        return jnp.sum(v * ct)

    prev = jattn.get_backend()
    jattn.set_backend(backend)
    try:
        jgrads = jax.grad(jloss)(jax.tree.map(jnp.asarray, jp))
    finally:
        jattn.set_backend(prev)
    tp = _requires_grad(_torch_params(jp))
    v = tdit.dit_apply(tp, TCFG, torch.from_numpy(x), torch.from_numpy(t),
                       torch.from_numpy(a), list(valid),
                       compute_dtype=torch.float32, backend=backend)
    (v * torch.from_numpy(ct)).sum().backward()
    _check_grads(tp, jgrads)


@pytest.mark.parametrize("option", [
    {"attention_backend": "xla"}, {"attention_backend": "fused"},
    {"attention_backend": "fused_mlp"},
    {"attention_backend": "fused_all", "int8_forward": True}],
    ids=["xla", "fused", "fused_mlp", "int8_forward"])
def test_trainer_step_matches_gtax(option, tmp_path, monkeypatch,
                                   gtax_globals):
    """One Trainer step under each training backend (and int8-forward,
    once a step quantizing the bf16 weights, here fp32) against gtax's
    Trainer: the loss and the gradient norm."""
    (got,), (ref,) = _steps_against_gtax(tmp_path, monkeypatch, 1, **option)
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"],
                               rtol=1e-5)
    rtol = 1e-3 if option.get("int8_forward") else 1e-4
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=rtol)
