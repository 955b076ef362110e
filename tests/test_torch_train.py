"""The slice end to end: 20 quickstart steps of mpi-SGD through the port's
``make_train_state -> make_train_step -> FlatEngine`` against the
reference's jitted ``make_train_step``, from the same weights, for each
fused optimizer family.

Adam and AdaGrad normalise each coordinate by its own gradient scale, so
with eps at 1e-8 / 1e-10 a coordinate whose gradient sits below the two
frameworks' summation noise (~1e-9 here) takes a full ±lr step of either
sign. The final-params comparison therefore runs with eps 1e-5 (AdamW)
and 1e-4 (AdaGrad), where such a coordinate's step is continuous in its
gradient; ``test_default_eps_losses`` holds the default-eps runs to the
per-step loss tolerance.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from _torch_parity import assert_params_close, port_run, reference_run  # noqa: E402
from repro_torch.kernels.fused_optim import fused_optim  # noqa: E402
from repro_torch.kernels.fused_sgd import fused_sgd  # noqa: E402

torch.set_num_threads(2)

STEPS = 20
QUICKSTART = {
    "sgd": dict(lr=0.1, momentum=0.9),
    "adamw": dict(lr=3e-3, eps=1e-5),
    "adagrad": dict(lr=1e-2, eps=1e-4),
}


@pytest.mark.parametrize("name", sorted(QUICKSTART))
def test_quickstart_trajectory_matches_reference(name):
    hyper = QUICKSTART[name]
    init, jlosses, jstate = reference_run(name, STEPS, **hyper)
    launches = (fused_sgd.sgd_momentum_flat.launches,
                fused_optim.adamw_flat.launches, fused_optim.adagrad_flat.launches)
    tlosses, tstate = port_run(init, name, STEPS, **hyper)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    assert tlosses[-1] < tlosses[0]
    assert_params_close(jstate["params"], tstate["params"], rtol=1e-3, atol=1e-5)
    assert int(tstate["step"]) == int(jstate["step"]) == STEPS
    # the CPU path ran the plain versions: no kernel launched
    assert launches == (fused_sgd.sgd_momentum_flat.launches,
                        fused_optim.adamw_flat.launches,
                        fused_optim.adagrad_flat.launches)
    # the flat state stream has the reference's p=1 layout
    if name == "adamw":
        assert tuple(tstate["opt"]["mv"].shape) == jstate["opt"]["mv"].shape
        assert int(tstate["opt"]["t"]) == int(jstate["opt"]["t"]) == STEPS
    else:
        assert tuple(tstate["opt"].shape) == jstate["opt"].shape
