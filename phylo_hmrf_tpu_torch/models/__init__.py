"""Emission, OU and EM-engine modules of the port."""
