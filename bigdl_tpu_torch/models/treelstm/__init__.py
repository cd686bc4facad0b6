"""The TreeLSTM sentiment example: see ``train.py`` for the model and the
main."""
