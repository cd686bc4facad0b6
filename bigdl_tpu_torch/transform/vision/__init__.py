from bigdl_tpu_torch.transform.vision.codec import UnsupportedImageError
from bigdl_tpu_torch.transform.vision.image import (
    AspectScale, Brightness, CenterCrop, ChannelNormalize, ChannelOrder,
    ColorJitter, Contrast, Expand, FeatureTransformer, HFlip, ImageFeature,
    ImageFrame, ImageFrameToSample, Lighting, MatToTensor, Pipeline,
    PixelBytesToMat, RandomCrop, RandomHFlip, RandomTransformer, Resize,
    Saturation,
)
