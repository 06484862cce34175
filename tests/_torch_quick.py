"""Set-up costs that the port's trainer-parity tests skip, since their
checks read neither: TensorBoard (``torch.utils.tensorboard`` imports
TensorFlow where it is installed, 7-16 s a process) and the JAX trainer's
eager ``policy.init`` (one XLA compile an operation; jitted, one compile).
The tests hand the JAX trainer's initial variables to the port, so both
packages start from whatever the init gives."""

import functools

import jax

import move2hear_tpu.rl.trainer as jtrainer
import move2hear_tpu_torch.pretrain.trainer as tpretrain
import move2hear_tpu_torch.rl.trainer as ttrainer
from move2hear_tpu.utils import tb as jtb
from move2hear_tpu.utils.tb import TensorboardWriter as JTensorboardWriter
from move2hear_tpu_torch.utils.tb import TensorboardWriter


def skip_setup_costs(mp) -> None:
    """The trainers' TensorBoard writers off (the JAX package's, the port's
    RL trainer's and its pretrain's) and the JAX policy's init jitted,
    through the monkeypatch `mp`."""
    mp.setattr(jtb, "TensorboardWriter", lambda *a, **k: JTensorboardWriter(""))
    for mod in (ttrainer, tpretrain):
        mp.setattr(mod, "TensorboardWriter", lambda *a, **k: TensorboardWriter(""))
    init = jtrainer.Move2HearPolicy.init

    def jitted_init(self, *args, **kwargs):
        return jax.jit(functools.partial(init, self))(*args, **kwargs)

    mp.setattr(jtrainer.Move2HearPolicy, "init", jitted_init)
