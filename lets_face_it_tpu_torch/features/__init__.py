"""Feature extraction (the port of ``lets_face_it_tpu/features``): dyadic
recordings to the per-frame features that ``features/combine.py`` packs
into ``lets_face_it.h5``.

Audio features (``dsp``, ``mfcc``, ``prosody``, ``vad``) run as whole-
utterance batches of ``torch`` operations on a device; FLAME landmark
fitting (``flame_fit``, ``ringnet_lite``, ``lipsync``) is a batched L-BFGS
of the port's own (``lbfgs``) over all frames at once; file IO, the combiner
and the external stages (``audio_io``, ``combine``, ``legacy_dataset``,
``video``, ``external``) are host code. ``h5py`` is imported only inside
the functions that read or write HDF5.
"""
