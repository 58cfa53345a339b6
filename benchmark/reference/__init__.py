"""The plain NumPy reference that decides ``correct``.

It reads the FASTA bytes the harness wrote and computes the TSV lines of
chosen rows with the measures' site predicates and float64 closed forms.
It imports nothing of the program under test and nothing of JAX: the
encoding table, the closed forms and the ``{:.12}`` formatting are
frozen copies kept in this folder.
"""
