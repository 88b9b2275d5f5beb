"""Core sketch engine: parameters, sketch containers, device orchestration."""
