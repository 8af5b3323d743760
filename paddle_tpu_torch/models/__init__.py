"""Model builders: the Transformer (training graph and the decode LM's
pieces, models/transformer.py) and the ResNet family (models/resnet.py)."""
