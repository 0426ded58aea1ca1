"""The benchmark's plain reference: Life-like and Larger-than-Life rules on
0/1 cells in plain PyTorch, written from the rules' published definitions.
It imports nothing of the program under test, and works out again from
the inputs whatever the program derived from them."""
