"""Operations and bytes from shapes and fixed iteration counts alone: what
the MFU and roofline figures divide by a measured time. Nothing here reads
a counter of the program."""
