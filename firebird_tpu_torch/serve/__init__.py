"""The serving layer's producer hooks: the product_writes feed
(``serve.changefeed``).  The HTTP server, its caches and the pyramid are
not ported yet."""
