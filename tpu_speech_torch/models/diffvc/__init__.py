from tpu_speech_torch.models.diffvc.encoder import FwdDiffusion, MelEncoder, PostNet
from tpu_speech_torch.models.diffvc.unet import GradLogPEstimatorVC, RefBlock
from tpu_speech_torch.models.diffvc.vc import DiffVC, voice_convert

__all__ = [
    "DiffVC",
    "FwdDiffusion",
    "GradLogPEstimatorVC",
    "MelEncoder",
    "PostNet",
    "RefBlock",
    "voice_convert",
]
