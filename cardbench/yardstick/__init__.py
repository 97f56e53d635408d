"""The benchmark's frozen yardstick: peaks, bounds and input generators.
Nothing here imports the program under test."""
