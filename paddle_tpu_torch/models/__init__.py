"""Model builders: the Transformer (training graph and the decode LM's
pieces, models/transformer.py), the Switch-MoE LM (models/moe.py), the
ResNet family (models/resnet.py), and the embedding models Wide&Deep CTR
(models/wide_deep.py), the recommender (models/recommender.py) and
word2vec (models/word2vec.py)."""
