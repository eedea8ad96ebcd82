"""Tile parallelism of the device pipeline: the tiles of a frame decided as
one batch of kernel launches on the card (see parallel/tiles.py)."""
