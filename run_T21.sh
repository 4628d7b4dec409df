#!/bin/bash
# The reference's canonical single-machine case (run_T21_sockets.sh):
# T21 GCM + 2 LES instances (64x64x160) near Barbados, 100 steps of 900 s,
# surface coupling on. Here there are no worker processes to size — the
# GCM, both LES instances, and the coupler run as one SPMD program on
# whatever jax.devices() provides (one GPU is plenty for this case).
#
# Reference: /root/reference/run_T21_sockets.sh

OUT=${OUT:-output}

python ./spmaster.py --steps "${STEPS:-100}" \
  --poly 20 -50 10 -50 10 -40 20 -40 \
  --numles 2 \
  --gcmexp TEST \
  --odir "$OUT" --cplsurf "$@"

# optional LES spinup, as in the reference:
#   --spinup 10800 --spinup_steps 12 --spinup_forcing 2
