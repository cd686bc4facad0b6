"""Keras-1.2-style user API of the port, exported as
``bigdl_tpu.nn.keras`` exports it."""

from bigdl_tpu_torch.nn.keras.layers import (
    Merge,
    Activation, AtrousConvolution2D, AveragePooling1D, AveragePooling2D,
    AveragePooling3D, BatchNormalization, Bidirectional, Convolution1D,
    Convolution2D, Convolution3D, Cropping1D, Cropping2D, Cropping3D,
    ConvLSTM2D, Deconvolution2D, Dense, Dropout, ELU, Embedding, Flatten, GRU,
    GaussianDropout, GaussianNoise, GlobalAveragePooling1D,
    GlobalAveragePooling2D, GlobalAveragePooling3D, GlobalMaxPooling1D,
    GlobalMaxPooling2D, GlobalMaxPooling3D, Highway,
    KerasLayer, LSTM, LayerNormalization, LeakyReLU, LocallyConnected1D,
    LocallyConnected2D, Masking, MaxPooling1D, MaxPooling2D, MaxPooling3D,
    MaxoutDense, PReLU, Permute, RepeatVector, Reshape, SReLU,
    SeparableConvolution2D,
    SimpleRNN, SpatialDropout1D, SpatialDropout2D, SpatialDropout3D,
    ThresholdedReLU, TimeDistributed, UpSampling1D, UpSampling2D, UpSampling3D,
    ZeroPadding1D, ZeroPadding2D, ZeroPadding3D,
)
from bigdl_tpu_torch.nn.keras.topology import (
    Input, KerasModel, KerasNode, Model, Sequential, merge,
)

# Keras-2 style aliases
Conv2D = Convolution2D
Conv1D = Convolution1D
Conv3D = Convolution3D

__all__ = [
    "Activation", "AtrousConvolution2D", "AveragePooling1D", "AveragePooling2D",
    "AveragePooling3D", "BatchNormalization", "Bidirectional", "Conv1D",
    "Conv2D", "Conv3D", "Convolution1D", "Convolution2D", "Convolution3D",
    "Cropping1D", "Cropping2D", "Cropping3D", "Deconvolution2D", "Dense",
    "Dropout", "ELU", "Embedding", "Flatten", "GRU", "GaussianDropout",
    "GaussianNoise", "GlobalAveragePooling1D", "GlobalAveragePooling2D",
    "GlobalMaxPooling1D", "GlobalMaxPooling2D", "Highway", "Input",
    "KerasLayer", "KerasModel", "KerasNode", "LSTM", "LayerNormalization",
    "LeakyReLU", "LocallyConnected1D", "LocallyConnected2D", "Masking",
    "MaxPooling1D", "MaxPooling2D", "MaxPooling3D", "MaxoutDense", "Model",
    "PReLU", "Permute", "RepeatVector", "Reshape", "SeparableConvolution2D",
    "Sequential", "SimpleRNN", "SpatialDropout1D", "SpatialDropout2D",
    "SpatialDropout3D", "ThresholdedReLU", "TimeDistributed", "UpSampling1D",
    "UpSampling2D", "UpSampling3D", "ZeroPadding1D", "ZeroPadding2D",
    "ZeroPadding3D", "Merge", "merge",
]
