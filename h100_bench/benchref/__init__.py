"""The benchmark's plain reference: float64 PyTorch on the card (or the
CPU in tests), imports nothing of the program under test.

``scene`` works the halo quantities out again from the par; ``sph`` the
SPH sums that judge a finished initial-conditions set.
"""
