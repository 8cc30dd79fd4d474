"""Plain PyTorch references of the benchmark's configurations. They import
nothing of the program and take nothing it made: only the configuration,
the seeded initial state and the inputs the benchmark draws."""
