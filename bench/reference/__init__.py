"""The benchmark's plain reference (``model.py``); it imports nothing of
the program."""
