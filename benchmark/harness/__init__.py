"""The benchmark's harness: everything a run does besides the program
under test and the plain reference."""
