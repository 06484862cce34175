"""The port's fresh weights against the JAX package's fresh flax weights, per
tensor, for ``Move2HearPolicy`` and ``Move2HearPassiveWoMemoryPolicy``. The
two draw from different generators, so the tensors are compared in
distribution: the flax tree goes through ``from_jax`` onto the port's
names and layouts, and then

  - a tensor the flax init makes constant (biases, BatchNorm scale, bias and
    statistics) is equal in the port, exactly;
  - a random tensor of 4,096 elements or more has a standard deviation
    within 5% of flax's (the sampling error of one std is 1/sqrt(2N), 1.1%
    at N = 4,096);
  - the GRU weights and both heads are orthogonal: W W^T (on the smaller
    side) is gain^2 I within 1e-5, with gain 0.01 for the action head and 1
    otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from move2hear_tpu.models import Move2HearPolicy as JPolicy
from move2hear_tpu.models.policy import Move2HearPassiveWoMemoryPolicy as JPassive
from move2hear_tpu_torch.models import Move2HearPassiveWoMemoryPolicy, Move2HearPolicy
from move2hear_tpu_torch.utils.params import from_jax
from _torch_threads import cap_torch_threads

cap_torch_threads()

HID = 512
ORTHOGONAL = {
    "pol_net.state_encoder.rnn.weight_ih_l0": 1.0,
    "pol_net.state_encoder.rnn.weight_hh_l0": 1.0,
    "action_dist.linear.weight": 0.01,
    "critic.fc.weight": 1.0,
}


def _flax_full():
    policy = JPolicy(num_actions=3, hidden_size=HID)
    obs = {
        "rgb": jnp.zeros((1, 128, 128, 3)), "depth": jnp.zeros((1, 128, 128, 1)),
        "mixed_bin_audio_mag": jnp.zeros((1, 512, 32, 2)),
        "target_class": jnp.zeros((1, 1), jnp.int32),
    }
    v = jax.jit(policy.init)(jax.random.PRNGKey(0), obs, jnp.zeros((1, HID)), jnp.ones((1, 1)))
    return from_jax(jax.tree.map(np.asarray, v["params"]),
                    jax.tree.map(np.asarray, v["batch_stats"]))


def _flax_passive():
    obs = {"mixed_bin_audio_mag": jnp.zeros((2, 512, 32, 2)),
           "target_class": jnp.zeros((2, 1), jnp.int32)}
    v = jax.jit(lambda k, o: JPassive().init(k, o, train=False))(jax.random.PRNGKey(0), obs)
    return from_jax(jax.tree.map(np.asarray, v["params"]),
                    jax.tree.map(np.asarray, v["batch_stats"]))


CASES = {
    "Move2HearPolicy": (_flax_full, lambda: Move2HearPolicy(3, HID)),
    "Move2HearPassiveWoMemoryPolicy": (_flax_passive, Move2HearPassiveWoMemoryPolicy),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fresh_init_matches_the_jax_package_per_tensor(name):
    flax_fn, port_fn = CASES[name]
    ref = flax_fn()
    torch.manual_seed(0)
    ours = port_fn().state_dict()
    assert set(ours) == set(ref)
    n_std = 0
    for k, r in ref.items():
        o = ours[k]
        assert o.shape == r.shape, k
        if "bias" in k.rsplit(".", 1)[-1]:
            assert not o.any(), k  # conv, dense, GRU, head and BatchNorm biases
        if bool((r == r.flatten()[0]).all()):
            assert torch.equal(o, r), k  # constant: biases, BatchNorm scale and statistics
            continue
        if r.numel() >= 4096:
            ratio = float(o.std()) / float(r.std())
            assert abs(ratio - 1.0) <= 0.05, (k, ratio)
            n_std += 1
        if k in ORTHOGONAL:
            w = o.double()
            gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
            eye = torch.eye(gram.shape[0], dtype=torch.float64) * ORTHOGONAL[k] ** 2
            assert float((gram - eye).abs().max()) <= 1e-5, k
    assert n_std >= (20 if name == "Move2HearPassiveWoMemoryPolicy" else 30)


def test_every_bias_starts_at_zero_and_the_generator_decides_the_draw():
    g = torch.Generator().manual_seed(3)
    a = Move2HearPolicy(3, 64, extra_depth=True, generator=g).state_dict()
    b = Move2HearPolicy(3, 64, extra_depth=True,
                        generator=torch.Generator().manual_seed(3)).state_dict()
    for k, v in a.items():
        assert torch.equal(v, b[k]), k
        if k.endswith("bias") or k.endswith("running_mean"):
            assert not v.any(), k
    c = Move2HearPolicy(3, 64, extra_depth=True,
                        generator=torch.Generator().manual_seed(4)).state_dict()
    assert not torch.equal(a["binSep_enc.cnn.0.0.weight"], c["binSep_enc.cnn.0.0.weight"])
