"""Core types, parallel tensor shapes and the PCG."""
