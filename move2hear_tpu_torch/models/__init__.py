from move2hear_tpu_torch.models.audio_cnn import AudioCNN
from move2hear_tpu_torch.models.distributions import Categorical, CategoricalNet, CriticHead
from move2hear_tpu_torch.models.memory import AcousticMem
from move2hear_tpu_torch.models.policy import (
    ActOutput, Move2HearPassiveWoMemoryPolicy, Move2HearPolicy, PolicyNet,
)
from move2hear_tpu_torch.models.rnn import GRUStateEncoder
from move2hear_tpu_torch.models.unet import PassiveSepDecoder, PassiveSepEncoder
from move2hear_tpu_torch.models.visual_cnn import VisualCNN

__all__ = [
    "AudioCNN", "Categorical", "CategoricalNet", "CriticHead", "AcousticMem",
    "ActOutput", "Move2HearPassiveWoMemoryPolicy", "Move2HearPolicy", "PolicyNet",
    "GRUStateEncoder",
    "PassiveSepDecoder", "PassiveSepEncoder", "VisualCNN",
]
