"""Fault handling shared by serving and training: the deterministic
fault injector and the health tracker / training supervisor."""
