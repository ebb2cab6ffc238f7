"""One driver a kind of traffic mix (the mix's ``kind``): its set-up,
measured window and check."""
