"""The benchmark's harness: finds a cell's configuration, traffic and
metric readers by name, runs the cell and prints its result line."""
