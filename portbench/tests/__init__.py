"""CPU tests of the benchmark (``python -m pytest portbench/tests``); the tests marked ``cuda`` run on a card."""
