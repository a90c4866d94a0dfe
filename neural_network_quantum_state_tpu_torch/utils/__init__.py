"""Utilities of the port that use no device: exact reference energies."""
