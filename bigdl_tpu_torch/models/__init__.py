"""Model zoo of the port: the decoder-only TransformerLM and the vision
zoo's ResNet, LeNet-5 and VGG (``models/resnet``, ``models/lenet``,
``models/vgg``)."""
