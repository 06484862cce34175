"""Vectorized host environments (``common/env_utils.py`` /
``sync_vector_env.py``), the JAX package's ``env/vector_env.py``. Two
launchers with one API:

  - SyncVectorEnv: every env in this process, stepped in turn;
  - ProcessVectorEnv: one forked process per env over pipes, with the
    reference's command protocol {STEP, RESET, CALL, COUNT_EPISODES, CLOSE}
    (env_utils.py:41-54,157-269).

API (a habitat-VectorEnv subset): reset(), step(actions), pause_at(i),
resume_all(), call(names, args), count_episodes(), num_envs, close().
Auto-reset on done happens inside the env (environment.py).

The workers fork from the trainer, which has usually set CUDA up by then.
A forked child must never touch CUDA: the env functions hold numpy data
only (scene graphs, audio and frame stores), the workers exchange numpy
arrays and Python values, and a worker leaves through ``os._exit`` (the
multiprocessing fork launcher's exit), so no finalizer of an inherited
CUDA object runs in it. The parent's objects are frozen out of the cyclic
garbage collector while the workers fork (``gc.freeze``), so no child
collection frees an inherited tensor either.
"""

import gc
import multiprocessing as mp
from typing import Any, Callable, List, Sequence, Tuple

STEP_CMD = "step"
RESET_CMD = "reset"
CLOSE_CMD = "close"
CALL_CMD = "call"
COUNT_EPISODES_CMD = "count_episodes"


class _VectorEnvBase:
    def __init__(self):
        self._paused: List[Tuple[int, Any]] = []

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


class SyncVectorEnv(_VectorEnvBase):
    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        super().__init__()
        self.envs = [fn() for fn in env_fns]

    @property
    def num_envs(self):
        return len(self.envs)

    def reset(self):
        return [env.reset() for env in self.envs]

    def step(self, actions):
        assert len(actions) == len(self.envs)
        return [env.step(a) for env, a in zip(self.envs, actions)]

    def pause_at(self, index):
        self._paused.append((index, self.envs.pop(index)))

    def resume_all(self):
        for index, env in reversed(sorted(self._paused, key=lambda x: x[0])):
            self.envs.insert(index, env)
        self._paused = []

    def call(self, function_names, function_args_list=None):
        args_list = function_args_list or [None] * len(function_names)
        results = []
        for env, name, args in zip(self.envs, function_names, args_list):
            fn = getattr(env, name)
            results.append(fn(**args) if args else fn())
        return results

    def count_episodes(self):
        return [env.number_of_episodes() for env in self.envs]

    def close(self):
        self.envs = []


def _worker(pipe, env_fn):
    env = env_fn()
    try:
        while True:
            cmd, data = pipe.recv()
            if cmd == STEP_CMD:
                pipe.send(env.step(data))
            elif cmd == RESET_CMD:
                pipe.send(env.reset())
            elif cmd == CALL_CMD:
                name, args = data
                fn = getattr(env, name)
                pipe.send(fn(**args) if args else fn())
            elif cmd == COUNT_EPISODES_CMD:
                pipe.send(env.number_of_episodes())
            elif cmd == CLOSE_CMD:
                pipe.send(None)
                break
    except (EOFError, KeyboardInterrupt):
        pass


class ProcessVectorEnv(_VectorEnvBase):
    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        super().__init__()
        ctx = mp.get_context("fork")
        self._pipes = []
        self._procs = []
        gc.freeze()
        try:
            for fn in env_fns:
                parent, child = ctx.Pipe(duplex=True)
                proc = ctx.Process(target=_worker, args=(child, fn))
                proc.daemon = True
                proc.start()
                child.close()
                self._pipes.append(parent)
                self._procs.append(proc)
        except BaseException:
            self.close()
            raise
        finally:
            gc.unfreeze()

    @property
    def num_envs(self):
        return len(self._pipes)

    def reset(self):
        for p in self._pipes:
            p.send((RESET_CMD, None))
        return [p.recv() for p in self._pipes]

    def async_step(self, actions):
        for p, a in zip(self._pipes, actions):
            p.send((STEP_CMD, a))

    def wait_step(self):
        return [p.recv() for p in self._pipes]

    def step(self, actions):
        self.async_step(actions)
        return self.wait_step()

    def pause_at(self, index):
        self._paused.append((index, (self._pipes.pop(index), self._procs.pop(index))))

    def resume_all(self):
        for index, (pipe, proc) in reversed(sorted(self._paused, key=lambda x: x[0])):
            self._pipes.insert(index, pipe)
            self._procs.insert(index, proc)
        self._paused = []

    def call(self, function_names, function_args_list=None):
        args_list = function_args_list or [None] * len(function_names)
        for p, name, args in zip(self._pipes, function_names, args_list):
            p.send((CALL_CMD, (name, args)))
        return [p.recv() for p in self._pipes]

    def count_episodes(self):
        for p in self._pipes:
            p.send((COUNT_EPISODES_CMD, None))
        return [p.recv() for p in self._pipes]

    def close(self):
        for _, (pipe, proc) in self._paused:
            self._pipes.append(pipe)
            self._procs.append(proc)
        self._paused = []
        for p in self._pipes:
            try:
                p.send((CLOSE_CMD, None))
                p.recv()
            except (BrokenPipeError, EOFError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
        self._pipes, self._procs = [], []


def construct_envs(env_fns: Sequence[Callable[[], Any]], use_sync: bool = True) -> _VectorEnvBase:
    """Launcher selection (env_utils.py:606-629). The env functions are
    closures over in-memory scene bundles, which only a forked child
    inherits; the reference pickles configs to forkserver workers instead."""
    if use_sync:
        return SyncVectorEnv(env_fns)
    return ProcessVectorEnv(env_fns)
