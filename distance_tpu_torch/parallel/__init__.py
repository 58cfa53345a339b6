"""Runs across processes and hosts: ``--launch``, ``--num-hosts``/``--host-id``,
``--coordinator`` and ``--merge`` (``multihost.py``).  The device mesh of
several cards is not ported yet."""
