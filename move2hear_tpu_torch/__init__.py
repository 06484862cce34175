"""PyTorch/CUDA port of ``move2hear_tpu`` for NVIDIA Hopper GPUs.

The package mirrors the JAX package's layout (``ops/``, ``models/``,
``env/``, ``eval/``, ``config/``, ``utils/``, ``rl/``, ``pretrain/``) and
imports only torch, numpy and the standard library. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; the two TPU kernels of the audio path,
and the backward of the first, are hand-written CUDA under ``csrc/`` (see
``ops/kernels.py``).

    python -m move2hear_tpu_torch.main --run-type train \\
        --exp-config configs/pretrain_passive.yaml --model-dir PRE
    python -m move2hear_tpu_torch.main --run-type train \\
        --exp-config configs/train/nearTarget.yaml --model-dir DIR \\
        RL.PPO.pretrained_passive_separators_ckpt PRE/data/best_ckpt_nonoverlapping_val.pth
    python -m move2hear_tpu_torch.main --run-type eval \\
        --exp-config configs/test/nearTarget.yaml --model-dir DIR \\
        EVAL_CKPT_PATH_DIR DIR/data/ckpt.N.pth
"""
