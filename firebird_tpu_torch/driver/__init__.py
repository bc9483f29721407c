"""The batch driver (``core``) and its dead-letter quarantine and run
manifest (``quarantine``); the stream driver (``stream``): bootstrap,
checkpoints and monthly updates."""
