"""Operations and bytes counted from shapes: what the algorithm needs for
the inputs, not what the program's eager operations move. One file per
kernel or model family."""
