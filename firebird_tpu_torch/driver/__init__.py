"""The batch driver (``core``) and its dead-letter quarantine and run
manifest (``quarantine``)."""
