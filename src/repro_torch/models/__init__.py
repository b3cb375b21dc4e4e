"""Workloads: the chain LSTM models and their cells."""
