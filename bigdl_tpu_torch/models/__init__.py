"""Model zoo of the port: the decoder-only TransformerLM and the vision
zoo's ResNet, LeNet-5, VGG and Inception (``models/resnet``,
``models/lenet``, ``models/vgg``, ``models/inception``)."""
