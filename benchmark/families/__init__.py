"""One module per model family: how a cell builds the program's side
(through the experiments' own loss functions) from the benchmark's weights and
inputs, and how the reference computes the same."""
