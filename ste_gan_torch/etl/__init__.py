"""Signal processing of the corpus preparation: filter design and spectral
helpers (``filters``), the EMG chain (``emg_dsp``) and the audio frontend
(``audio_dsp``)."""
