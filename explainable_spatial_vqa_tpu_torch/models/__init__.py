"""The program generator, the program executor and their building blocks."""
