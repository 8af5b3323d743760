"""Model builders. This slice carries the pieces of models/transformer.py
that the decode LM uses."""
