"""Checkpoints in the reference's file format (``checkpoint/io.py``):
either package restores what the other wrote."""
